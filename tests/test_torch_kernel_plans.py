"""The launch plans of the port's RMSNorm and GA group-label kernels, on the
CPU (no card needed): which variant each call goes to and the launch shape
it gets.

``repro_torch.kernels.rmsnorm.ops.plan`` picks ``vector`` (16-byte vectors,
a group of threads per row) or ``generic`` (a block per row);
``repro_torch.kernels.ga_labels.ops.plan`` picks ``warp`` (a warp per genome
row), ``block`` (a block per row) or ``global`` (a block per row, its words
in device memory).  The kernels themselves are held against their plain
versions on the card by ``chip_smoke.py`` (phase 3), every variant at every
case it can take.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS, get_config
from repro.workloads.cnn_zoo import WORKLOADS, build_workload
from repro_torch.kernels.ga_labels import ops as ga_ops
from repro_torch.kernels.ga_labels.ops import ga_labels
from repro_torch.kernels.ga_labels.ref import label_tables
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.rmsnorm.ops import fused_rmsnorm

ROOT = Path(__file__).resolve().parents[1]
# an H100's opt-in shared memory a block (232448 bytes) less the block
# variant's static 256-word carry, in int32 words, and its 132 SMs (what
# ga_labels.card reads from the card)
H100_SHARED_WORDS = (232448 - 256 * 4) // 4
H100 = ga_ops.Card(H100_SHARED_WORDS, 132)
D_MODELS = sorted({get_config(a).d_model for a in ARCH_IDS})
DTYPES = (torch.bfloat16, torch.float32)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CHIP_SMOKE = _chip_smoke()


# ---- RMSNorm ----

def test_d_models_are_the_ten_configs():
    assert len(ARCH_IDS) == 10
    assert D_MODELS[0] == 768 and D_MODELS[-1] == 6144


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", D_MODELS)
def test_rmsnorm_plan_takes_vector_for_every_config(d, dtype):
    """The plan reads no row count: decode (8 rows) and prefill (32768)
    rows of a config take the same plan."""
    how = rms_ops.plan(d, dtype)
    assert how.variant == "vector"
    assert rms_ops.variants(d, dtype) == ("vector", "generic")
    assert how.threads in rms_ops.GROUPS
    assert rms_ops.BLOCK % how.threads == 0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", D_MODELS)
def test_rmsnorm_plan_covers_the_row_once(d, dtype):
    """Thread t of a row holds vectors t, t + threads, ... below d /
    vec_elems: every value of [0, d) belongs to exactly one (thread,
    vector) slot."""
    how = rms_ops.plan(d, dtype)
    e = rms_ops.VECTOR_BYTES // dtype.itemsize
    seen = np.zeros(d, dtype=np.int64)
    for t in range(how.threads):
        for k in range(how.vectors):
            j = t + k * how.threads
            if j < d // e:
                seen[j * e:(j + 1) * e] += 1
    assert (seen == 1).all()
    # no thread holds a vector slot that every thread could do without
    assert (how.vectors - 1) * how.threads < d // e


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", D_MODELS + [64, 130 * 8, 16384])
def test_rmsnorm_plan_stays_within_the_register_budget(d, dtype):
    """A thread holds V vectors (4 words each) of this row and the next of x
    and r, and V of w: 20 V words in the residual form, at most
    REG_BUDGET."""
    how = rms_ops.plan(d, dtype)
    if how.variant == "vector":
        assert 1 <= how.vectors <= rms_ops.VMAX
        assert 20 * how.vectors <= rms_ops.REG_BUDGET


def test_rmsnorm_plan_prefers_vectors_near_the_target():
    """Fewest idle vector slots, then the vector count nearest VTARGET: 64
    threads of 5 vectors at d 2560 bf16, 128 of 4 at 4096."""
    assert rms_ops.plan(2560, torch.bfloat16).threads == 64
    assert rms_ops.plan(2560, torch.bfloat16).vectors == 5
    assert rms_ops.plan(4096, torch.bfloat16).threads == 128
    assert rms_ops.plan(4096, torch.bfloat16).vectors == 4


@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_plan_takes_generic_where_vectors_do_not_fit(dtype):
    assert rms_ops.plan(130, dtype).variant == "generic"
    assert rms_ops.variants(130, dtype) == ("generic",)
    assert rms_ops.plan(4096, dtype, aligned=False).variant == "generic"
    # past 256 threads of VMAX vectors a row
    too_wide = 256 * rms_ops.VMAX * (16 // dtype.itemsize) + 16
    assert rms_ops.plan(too_wide, dtype).variant == "generic"
    with pytest.raises(ValueError, match="cannot take"):
        rms_ops.plan(130, dtype, variant="vector")
    assert rms_ops.plan(4096, dtype, variant="generic").variant == \
        "generic"


# ---- GA group labels ----

def _extra(cg) -> int:
    return int((np.asarray(cg.ev) != np.asarray(cg.eu) + 1).sum())


@pytest.mark.parametrize("P", [1, 63, 128, 65536])
@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_ga_plan_takes_warp_for_every_zoo_graph(name, P):
    cg = build_workload(name).compiled()
    how = ga_ops.plan(P, cg.n, cg.m, _extra(cg), H100)
    assert how.variant == "warp"
    assert how.bit_words == 1


def test_ga_plan_pins_the_chains():
    """The 1040-node chain with skips: a warp block of eight of its rows
    (2772 words each) and the tables exceed a third of a block's shared
    memory, so ``block``; the 29928-node chain does not fit shared memory
    at all, so ``global``."""
    eu, ev = CHIP_SMOKE.chain_with_skips(1040, seed=5)
    tb = label_tables(eu, ev, 1040, "cpu")
    n_extra = tb.xu.numel()
    assert ga_ops.row_words(1040, n_extra) == 2772
    assert 1040 + 3 * n_extra + 8 * 2772 > \
        H100_SHARED_WORDS // ga_ops.MIN_BLOCKS
    assert ga_ops.plan(65536, 1040, tb.m, n_extra, H100).variant == "block"
    # the warp variant can still take it (2 words of bits a lane) when forced
    assert ga_ops.variants(1040, tb.m, n_extra, H100_SHARED_WORDS) == \
        ("warp", "block", "global")
    forced = ga_ops.plan(65536, 1040, tb.m, n_extra, H100, variant="warp")
    assert forced.bit_words == 2
    n_long = H100_SHARED_WORDS // 2 + 1000
    assert n_long == 29928
    eu, ev = CHIP_SMOKE.chain_with_skips(n_long, seed=6)
    tb = label_tables(eu, ev, n_long, "cpu")
    assert ga_ops.plan(4096, n_long, tb.m, tb.xu.numel(),
                       H100).variant == "global"
    assert ga_ops.variants(n_long, tb.m, tb.xu.numel(),
                           H100_SHARED_WORDS) == ("global",)
    with pytest.raises(ValueError, match="cannot take"):
        ga_ops.plan(4096, n_long, tb.m, tb.xu.numel(), H100,
                    variant="block")


def _chain(n):
    eu, ev = CHIP_SMOKE.chain_with_skips(n, seed=7)
    tb = label_tables(eu, ev, n, "cpu")
    return n, tb.m, tb.xu.numel()


@pytest.mark.parametrize("n, want", [(800, "warp"), (820, "warp"),
                                     (830, "block"), (920, "block")])
def test_ga_plan_crossover_chains(n, want):
    """The chains either side of the warp/block crossover on an H100, at
    65536 genomes and at the engine's 64: a warp block of eight rows takes
    the tables and eight rows' words, 19127 words at 820 nodes and 19354 at
    830, against a third of a block's shared memory (19285); the sweep
    measured ``warp`` ahead at 800 nodes and behind at 920."""
    graph = _chain(n)
    words = {800: 18654, 820: 19127, 830: 19354, 920: 21454}[n]
    assert graph[0] + 3 * graph[2] + ga_ops.MAX_ROWS * ga_ops.row_words(
        n, graph[2]) == words
    assert H100_SHARED_WORDS // ga_ops.MIN_BLOCKS == 19285
    assert ga_ops.plan(65536, *graph, H100).variant == want
    assert ga_ops.plan(64, *graph, H100).variant == want


def test_ga_plan_reads_the_card():
    """The SM count sets the rows per block and the shared memory sets the
    crossover: on a quarter of an H100's SMs (33), 128 rows take two a
    block (64 blocks; four a block would leave 32, fewer than the SMs); with
    half its shared memory, the 800-node chain goes to ``block``."""
    cg = build_workload("resnet50").compiled()
    args = (128, cg.n, cg.m, _extra(cg))
    assert ga_ops.plan(*args, H100).rows_per_block == 1
    assert ga_ops.plan(*args, ga_ops.Card(H100_SHARED_WORDS, 33)
                       ).rows_per_block == 2
    graph = _chain(800)
    assert ga_ops.plan(65536, *graph, H100).variant == "warp"
    half = ga_ops.Card(H100_SHARED_WORDS // 2, 132)
    assert ga_ops.plan(65536, *graph, half).variant == "block"


@pytest.mark.parametrize("P", [1, 63, 128, 65536])
@pytest.mark.parametrize("name", ["mobilenet_v3", "resnet50", "chain1040"])
def test_ga_plan_stays_within_the_card(name, P):
    """Rows per block and shared memory within the card's limits (1024
    threads, the opt-in shared memory), and the batch spread over the SMs:
    one row a block below 2 x 132 rows, 8 at 65536."""
    if name == "chain1040":
        eu, ev = CHIP_SMOKE.chain_with_skips(1040, seed=5)
        n = 1040
    else:
        cg = build_workload(name).compiled()
        eu, ev, n = cg.eu, cg.ev, cg.n
    tb = label_tables(eu, ev, n, "cpu")
    how = ga_ops.plan(P, n, tb.m, tb.xu.numel(), H100, variant="warp")
    assert 1 <= how.rows_per_block <= ga_ops.MAX_ROWS
    assert 32 * how.rows_per_block <= 1024
    assert how.shared_words == (n + 3 * tb.xu.numel() + how.rows_per_block
                                * ga_ops.row_words(n, tb.xu.numel()))
    assert 4 * how.shared_words <= 4 * H100_SHARED_WORDS
    blocks = -(-P // how.rows_per_block)
    assert blocks >= min(P, H100.sms)
    if P in (63, 128):
        assert how.rows_per_block == 1
    if P == 65536 and name != "chain1040":
        assert how.rows_per_block == ga_ops.MAX_ROWS


def test_label_tables_index_chain_edges_by_node():
    cg = build_workload("mobilenet_v3").compiled()
    tb = label_tables(cg.eu, cg.ev, cg.n, "cpu")
    into = tb.chain_into.numpy()
    assert tb.chain_into.dtype == torch.int32 and into.shape == (cg.n,)
    want = np.full(cg.n, -1)
    for k, e in zip(tb.chain_nodes.numpy(), tb.chain_eids.numpy()):
        want[k + 1] = e
    assert np.array_equal(into, want) and into[0] == -1


# ---- forcing a variant ----

def test_unknown_variant_raises_on_both_wrappers():
    x = torch.ones(2, 8)
    with pytest.raises(ValueError, match="unknown variant"):
        fused_rmsnorm(x, torch.ones(8), variant="scalar")
    with pytest.raises(ValueError, match="unknown variant"):
        rms_ops.plan(8, torch.float32, variant="scalar")
    cg = build_workload("resnet50").compiled()
    tb = label_tables(cg.eu, cg.ev, cg.n, "cpu")
    bits = torch.zeros(4, cg.m, dtype=torch.uint8)
    with pytest.raises(ValueError, match="unknown variant"):
        ga_labels(bits, tb, variant="shared")
    with pytest.raises(ValueError, match="unknown variant"):
        ga_ops.plan(4, cg.n, cg.m, _extra(cg), H100, variant="shared")


def test_known_variants_take_the_plain_path_on_the_cpu():
    """A variant names a CUDA kernel; a CPU tensor still takes the plain
    version, and no launch is counted."""
    x = torch.randn(3, 16)
    w = torch.ones(16)
    before = dict(fused_rmsnorm.variant_launches)
    for v in rms_ops.VARIANTS:
        torch.testing.assert_close(fused_rmsnorm(x, w, variant=v),
                                   fused_rmsnorm(x, w))
    cg = build_workload("mobilenet_v3").compiled()
    tb = label_tables(cg.eu, cg.ev, cg.n, "cpu")
    bits = (torch.rand(5, cg.m, generator=torch.Generator().manual_seed(0))
            < 0.5).to(torch.uint8)
    for v in ga_ops.VARIANTS:
        assert torch.equal(ga_labels(bits, tb, variant=v),
                           ga_labels(bits, tb))
    assert fused_rmsnorm.variant_launches == before
