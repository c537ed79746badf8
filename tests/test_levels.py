from mgroms_jax.levels import (build_level_plan, build_shard_plan,
                               find_grid_levels)


def test_find_grid_levels_seamount():
    # 64^3: horizontal allows 5 levels (64 -> 4), vertical 6 (64 -> 2)
    assert find_grid_levels(64, 64, 64) == 5


def test_find_grid_levels_vertical_limited():
    # nz=8 limits: nl2 = 1+log2(8/2) = 3
    assert find_grid_levels(64, 64, 8) == 3


def test_level_dims_seamount():
    levels = build_level_plan(64, 64, 64)
    dims = [(l.nxg, l.nyg, l.nzg) for l in levels]
    assert dims == [(64, 64, 64), (32, 32, 32), (16, 16, 16),
                    (8, 8, 8), (4, 4, 4)]
    assert all(l.nd == 8 for l in levels)


def test_level_dims_2d_tail():
    # deep horizontal hierarchy with shallow nz: nz halves to 1 then 2-D
    levels = build_level_plan(256, 256, 4)
    # nlevs = min(1+log2(256/4)=7, 1+log2(4/2)=2) = 2
    assert len(levels) == 2
    assert levels[-1].nzg == 2


def test_cuc_levels():
    # CUC case: 1024x1024x64 -> min(9, 6) = 6 levels
    levels = build_level_plan(1024, 1024, 64)
    assert len(levels) == 6
    assert (levels[-1].nxg, levels[-1].nzg) == (32, 2)


def test_shard_plan_deshard():
    levels = build_level_plan(256, 256, 64)   # 6 levels, 256 -> 8
    shards = build_shard_plan(levels, npx=4, npy=2, nsmall=8)
    # level 0: 64x128 local -> sharded; dims halve per level:
    # local nx: 64,32,16,8,4 -> de-shard when nx//npx < 8
    assert shards[0].sharded and shards[0].nx == 64
    assert shards[3].sharded          # 32//4 = 8 local, not < 8
    # staged agglomeration: 16//4 = 4 < 8 drops px only (py still 16//2=8)
    assert shards[4].sharded and shards[4].shard_py and not shards[4].shard_px
    assert shards[4].nx == 16 and shards[4].ny == 8
    # 8//2 = 4 < 8 drops py too -> fully replicated, monotonic
    assert not shards[5].sharded


def test_shard_plan_single_device():
    levels = build_level_plan(64, 64, 64)
    shards = build_shard_plan(levels, 1, 1)
    assert all(not s.sharded for s in shards)
