"""K1's, K2's and K4's launch plans (the arithmetic kept in Python, beside
the kernels' wrappers) at every main-path shape and at edge shapes. Runs on
the CPU: the plans are what the wrappers hand to csrc/decode_attention.cu,
csrc/int8_gemv.cu and csrc/int4_gemv.cu."""
import pytest

from faster_qwen3_tts_tpu_torch.ops import attention, quant

SMEM_LIMIT = 232448  # 227 KB, the dynamic shared memory an H100 block may use
SMS = 132

# (I, O) of every Q8_0 projection of the 0.6B and 1.7B talkers and their predictor
MAIN_GEMV = [(1024, 2048), (1024, 1024), (2048, 1024), (1024, 3072), (3072, 1024), (2048, 2048),
             (2048, 6144), (6144, 2048), (2048, 3072)]
EDGE_GEMV = [(96, 128), (64, 32), (128, 64), (160, 48), (1, 16), (4096, 16), (32768, 128)]


@pytest.mark.parametrize("M", [1, 2, 9, 16])
@pytest.mark.parametrize("I, O", MAIN_GEMV + EDGE_GEMV)
@pytest.mark.parametrize("elt", [2, 4])
def test_gemv_plan(M, I, O, elt):
    p = quant._gemv_plan(M, I, O, elt)
    tiles = -(-O // 128)
    # clusters: at most 8 CTAs (portable), along x, dividing the grid
    assert 1 <= p.cluster <= 8
    assert p.grid[0] == tiles * p.cluster and p.grid[0] % p.cluster == 0
    # the K-split covers I exactly: every CTA has rows, together they reach I
    assert p.rows_per_cta % 64 == 0
    assert p.cluster * p.rows_per_cta >= I > (p.cluster - 1) * p.rows_per_cta
    # the row groups of grid.y cover the M rows of x
    assert p.mr in (1, 2, 4) and p.mr * p.grid[1] >= M > p.mr * (p.grid[1] - 1)
    # shared memory: the ring, the cluster's partials, the barriers, x's slice
    assert p.smem == (128 + 8 * 64 * 128 + (p.mr * 128 + 8) * 4 + 8 * 8
                      + -(-p.mr * p.rows_per_cta * elt // 16) * 16)
    assert p.smem <= SMEM_LIMIT
    # at most two CTAs per SM in one wave
    ctas = p.grid[0] * p.grid[1]
    assert ctas <= 2 * SMS or p.cluster == 1


@pytest.mark.parametrize("M", [1, 2])
@pytest.mark.parametrize("I, O", MAIN_GEMV)
def test_gemv_plan_fills_the_card_on_the_main_path(M, I, O):
    """Decode projections (M = 1, 2) take a full cluster of 8 per tile or fill
    the card about twice; a slab is at most 12 stages of 64 rows (the 1.7B
    down projection), so every stage but a few is in flight at once."""
    p = quant._gemv_plan(M, I, O, 2)
    tiles = -(-O // 128)
    assert min(8 * tiles, 2 * SMS - tiles) <= p.grid[0] * p.grid[1] <= 2 * SMS
    assert p.rows_per_cta <= 12 * 64


@pytest.mark.parametrize("M, I, O", [(0, 64, 64), (17, 64, 64), (1, 64, 40), (1, 0, 64), (1, 64, 8)])
def test_gemv_plan_refuses(M, I, O):
    with pytest.raises(ValueError):
        quant._gemv_plan(M, I, O, 2)


# (I, O, group): the int4 shapes of every projection (group 32), a layer that
# is one group (48 rows), groups that split unevenly, a very long reduction
EDGE_GEMV4 = [(96, 128, 32), (64, 32, 32), (48, 32, 48), (160, 48, 32), (2, 16, 2), (32768, 128, 32),
              (256, 96, 64)]


@pytest.mark.parametrize("M", [1, 2, 9, 16])
@pytest.mark.parametrize("I, O, group", [(I, O, 32) for I, O in MAIN_GEMV] + EDGE_GEMV4)
def test_int4_plan(M, I, O, group):
    p = quant._int4_plan(M, I, O, group)
    tiles, n_groups = -(-O // 128), I // group
    mr = M if M <= 2 else 4
    assert p.mr == mr and 1 <= p.cluster <= 8
    assert p.grid == (tiles * p.cluster, -(-M // mr))
    # every CTA of a cluster owns whole groups, the last at least one
    assert p.groups_per_cta * p.cluster >= n_groups > p.groups_per_cta * (p.cluster - 1)
    # about two CTAs an SM at most, unless one CTA a tile is already more
    assert p.cluster == 1 or tiles * p.grid[1] * p.cluster <= 2 * SMS
    # csrc/int4_gemv.cu smem_bytes: warp partials, cluster partials, x's slice, group sums
    assert p.smem == (8 * mr * 128 + mr * 128 + 8 + mr * p.groups_per_cta * group + mr * p.groups_per_cta) * 4
    assert p.smem <= SMEM_LIMIT


@pytest.mark.parametrize("M", [1, 16])
@pytest.mark.parametrize("I, O", [(1024, 1024), (1024, 3072), (2048, 1024)])
def test_int4_plan_fills_the_card_on_the_main_path(M, I, O):
    """At O = 1024 there are 8 column tiles: the split of I fills the card."""
    p = quant._int4_plan(M, I, O, 32)
    assert p.grid[0] * p.grid[1] >= 64


@pytest.mark.parametrize("M, I, O, group", [(17, 1024, 1024, 32), (0, 1024, 1024, 32), (1, 1024, 40, 32),
                                            (1, 66, 32, 33), (1, 96, 32, 64), (1, 1024, 8, 32)])
def test_int4_plan_refuses(M, I, O, group):
    with pytest.raises(ValueError):
        quant._int4_plan(M, I, O, group)


# (B, S_max, Hq, Hkv, D): the talker and predictor caches of both sizes, a
# VoiceDesign-length cache, the longest cache, and the tiny card-vs-CPU geometry
MAIN_ATTN = [(1, 2048, 16, 8, 128), (1, 17, 16, 8, 128), (1, 4096, 16, 8, 128), (1, 300, 16, 8, 128),
             (1, 32768, 16, 8, 128), (2, 2048, 16, 8, 128), (1, 256, 4, 2, 32), (1, 17, 2, 1, 32),
             (1, 64, 8, 1, 64), (1, 1, 16, 16, 256)]


@pytest.mark.parametrize("B, S, Hq, Hkv, D, elt", [(*case, elt) for case in MAIN_ATTN for elt in (2, 4)
                                                  if case[-1] * elt <= 512])  # longer rows: refused
def test_decode_plan(B, S, Hq, Hkv, D, elt):
    p = attention._decode_plan(B, S, Hq, Hkv, D, elt)
    n_tiles = -(-S // 32)
    assert 1 <= p.cluster <= 8 and p.grid == (p.cluster, Hkv, B)
    assert p.cluster <= n_tiles  # no CTA without a tile at a full cache
    assert p.smem <= SMEM_LIMIT
    # shared memory: the ring (or the slot-group sums), q, the partials, the small arrays
    row = D * elt
    pitch = row + ((16 - (row // 4) % 32) % 32) * 4
    assert pitch % 16 == 0 and (pitch // 4) % 32 == 16  # slot rows 16 banks apart
    G = Hq // Hkv
    ring = 4 * 2 * 32 * pitch
    red = (128 // (row // 16)) * G * D * 4
    assert p.smem >= max(ring, red) + 2 * G * D * 4


def test_decode_plan_picks_the_cluster_from_s_max():
    """1 CTA for the predictor's 17 slots, 8 for the talker's 2048: 8 kv
    heads x 8 = 64 CTAs."""
    assert attention._decode_plan(1, 17, 16, 8, 128, 2).cluster == 1
    talker = attention._decode_plan(1, 2048, 16, 8, 128, 2)
    assert talker.cluster == 8 and talker.grid[0] * talker.grid[1] * talker.grid[2] == 64
    assert attention._decode_plan(1, 256, 16, 8, 128, 2).cluster == 2


@pytest.mark.parametrize("B, S, Hq, Hkv, D, elt", [(1, 2048, 16, 8, 16, 2), (1, 2048, 12, 4, 128, 2),
                                                  (1, 2048, 16, 8, 96, 2), (1, 40000, 16, 8, 128, 2),
                                                  (1, 2048, 16, 8, 256, 4), (1, 2048, 15, 8, 128, 2)])
def test_decode_plan_refuses(B, S, Hq, Hkv, D, elt):
    with pytest.raises(ValueError):
        attention._decode_plan(B, S, Hq, Hkv, D, elt)
