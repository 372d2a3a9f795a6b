"""The port's ``tpu`` cost model, roofline and TPU-schedule search against
the reference's, on the CPU.

Every result here is a plain float expression copied term for term from the
reference, so the port must give *equal* results, not close ones:
``estimate`` on all ten configs x the four shapes x every ``TpuSchedule``;
the HLO collective parser and ``roofline_from_artifact`` on the
reference's HLO sample and on hand-built artifacts; the schedule search
with every backend at fixed seeds; the fusion-side ``TpuFusionCostModel``
per group; and ``--costmodel tpu`` CNN searches as whole artifacts
(``device="cpu"``: the label pass's plain version).  The reference's own
cases (``tests/test_roofline.py:72-107``, ``tests/test_report.py:28``,
``tests/test_costmodel_protocol.py:111-157``) run on the port as well, and
the golden constants ``chip_smoke.py`` holds the card's runs to are pinned
to the reference's results.
"""
import dataclasses
import importlib.util
import json
from pathlib import Path

import pytest

from repro.configs import ARCH_IDS as REF_ARCH_IDS
from repro.configs import cell_skip_reason as ref_cell_skip_reason
from repro.configs import get_config as ref_get_config
from repro.configs import get_reduced as ref_get_reduced
from repro.configs import iter_cells as ref_iter_cells
from repro.configs.base import SHAPES as REF_SHAPES
from repro.costmodel import SIMBA as REF_SIMBA
from repro.costmodel import Evaluator as RefEvaluator
from repro.costmodel import TpuFusionCostModel as RefTpuFusion
from repro.costmodel import tpu_model as ref_tpu_model
from repro.roofline import analysis as ref_roofline
from repro.search import search as ref_search
from repro.search.tpu import search_tpu_schedule as ref_search_tpu
from repro.workloads import mobilenet_v3_large as ref_mobilenet
from repro_torch.configs import (ARCH_IDS, SERVED_ARCHS, SHAPES,
                                 cell_skip_reason, get_config, get_reduced,
                                 iter_cells)
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.fusion import FusionState
from repro_torch.core.ga import GAConfig
from repro_torch.core.graph import Layer, LayerGraph
from repro_torch.core.tpu_ga import optimize_tpu_schedule
from repro_torch.costmodel import SIMBA, Evaluator, TpuFusionCostModel
from repro_torch.costmodel.tpu_model import (MICROBATCH_OPTIONS,
                                             REMAT_OPTIONS,
                                             SHARDING_OPTIONS, TpuSchedule,
                                             estimate)
from repro_torch.roofline import (HW, collective_bytes,
                                  roofline_from_artifact)
from repro_torch.search import COSTMODELS, search
from repro_torch.search.tpu import TpuScheduleProblem, search_tpu_schedule
from repro_torch.serve.store import artifact_key
from repro_torch.workloads import mobilenet_v3_large
from tests.test_roofline import HLO_SAMPLE
from tests.test_torch_ga_search import _comparable

ROOT = Path(__file__).resolve().parents[1]
SCHEDULES = [TpuSchedule(r, m, g, s) for r in REMAT_OPTIONS
             for m in MICROBATCH_OPTIONS for g in (False, True)
             for s in SHARDING_OPTIONS]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ref_schedule(s: TpuSchedule):
    return ref_tpu_model.TpuSchedule(**dataclasses.asdict(s))


def _chain(n: int) -> LayerGraph:
    """tests/test_fusion.py:chain, carried to the port through its IR."""
    from repro_torch.ir import GraphIR
    from tests.test_fusion import chain
    return LayerGraph.from_ir(GraphIR.from_json(chain(n).to_ir().to_json()))


# ---- configs as data ------------------------------------------------------------

@pytest.mark.parametrize("arch", REF_ARCH_IDS)
def test_every_config_is_the_references(arch):
    """All ten configs, full and reduced: every field of the reference's
    schema, the derived properties and the parameter counts."""
    for port, ref in ((get_config(arch), ref_get_config(arch)),
                      (get_reduced(arch), ref_get_reduced(arch))):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.layer_kinds() == ref.layer_kinds()
        assert port.resolved_head_dim == ref.resolved_head_dim
        assert port.n_params == ref.n_params
        assert port.n_active_params == ref.n_active_params


def test_registry_schema_and_cells_are_the_references():
    assert ARCH_IDS == REF_ARCH_IDS and len(ARCH_IDS) == 10
    ref_fields = {f.name: f.default
                  for f in dataclasses.fields(ref_get_config(ARCH_IDS[0]))}
    assert {f.name: f.default for f in dataclasses.fields(ModelConfig)} \
        == ref_fields
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in REF_SHAPES.items()}
    assert all(isinstance(s, ShapeConfig) and s.is_train ==
               REF_SHAPES[k].is_train for k, s in SHAPES.items())
    cells = [(a, s, r) for a, s, _, r in iter_cells()]
    assert cells == [(a, s, r) for a, s, _, r in ref_iter_cells()]
    assert len(cells) == 40
    for arch in ARCH_IDS:
        for shape in SHAPES:
            assert cell_skip_reason(arch, shape) == \
                ref_cell_skip_reason(arch, shape)


def test_only_the_ported_families_are_served():
    """The serve path builds only SERVED_ARCHS: all ten configs, in the
    order they were ported; a config with a feature none of them sets (the
    logit softcap) is still refused."""
    from repro_torch.launch import serve
    from repro_torch.models.transformer import Transformer, check_ported
    assert SERVED_ARCHS == ["chatglm3-6b", "recurrentgemma-2b",
                            "falcon-mamba-7b", "phi-3-vision-4.2b",
                            "qwen2-7b", "stablelm-1.6b", "starcoder2-3b",
                            "whisper-small", "dbrx-132b",
                            "llama4-maverick-400b-a17b"]
    assert sorted(SERVED_ARCHS) == sorted(ARCH_IDS)
    for arch in ARCH_IDS:
        check_ported(get_config(arch))
        capped = dataclasses.replace(get_reduced(arch),
                                     attn_logit_softcap=30.0)
        with pytest.raises(NotImplementedError):
            check_ported(capped)
        with pytest.raises(NotImplementedError):
            Transformer(capped, "cpu")
    with pytest.raises(SystemExit):
        serve.main(["--arch", "no-such-arch", "--reduced", "--device", "cpu"])


# ---- the roofline ----------------------------------------------------------------

@pytest.mark.parametrize("hlo", [
    HLO_SAMPLE, "%dot = f32[4,4]{1,0} dot(%a, %b)", "",
    HLO_SAMPLE * 3 + "\n  %ar = s64[7]{0} all-reduce(%x)\n"
    "  %t = (bf16[2,3]{1,0}, pred[5]{0}) all-gather(%a, %b)\n"
    "  %odd = c128[2]{0} collective-permute(%z)\n"
    "  %x = zz9[4]{0} reduce-scatter(%q)\n"])
def test_collective_bytes_equals_the_references(hlo):
    assert collective_bytes(hlo) == ref_roofline.collective_bytes(hlo)


def test_collective_bytes_parses_all_kinds():
    """tests/test_roofline.py:29-41 on the port."""
    out = collective_bytes(HLO_SAMPLE)
    assert out["all-reduce"] == 16 * 512 * 128 * 2
    assert out["all-gather"] == 1024 * 32 * 4
    assert out["reduce-scatter"] == 64 * 2
    assert out["all-to-all"] == 2 * 8 * 16 * 4          # tuple result
    assert out["collective-permute"] == 100
    assert out["count"] == 5
    assert collective_bytes("%dot = f32[4,4]{1,0} dot(%a, %b)")["count"] == 0


def _terms(t) -> dict:
    return dict(dataclasses.asdict(t), dominant=t.dominant,
                step_time_s=t.step_time_s,
                roofline_fraction=t.roofline_fraction)


@pytest.mark.parametrize("art", [
    {"chips": 256, "cost": {"flops": 197e12, "bytes accessed": 819e9 * 2},
     "collectives": {"all-reduce": int(50e9 * 0.5), "count": 3}},
    {"chips": 4, "cost": {"flops": 3.5e15, "bytes accessed": 1.25e11},
     "collectives": collective_bytes(HLO_SAMPLE)},
    {"chips": 1, "cost": {}, "collectives": {"count": 0}},
    {"chips": 16, "cost": {"flops": 1e9, "bytes accessed": 2e9},
     "collectives": {"all-to-all": 10 ** 12, "all-gather": 3, "count": 2}},
])
def test_roofline_from_artifact_equals_the_references(art):
    got = roofline_from_artifact(art)
    ref = ref_roofline.roofline_from_artifact(art)
    assert _terms(got) == _terms(ref)
    hw = HW(peak_flops=1e15, hbm_bw=2e12, ici_bw=1e11, hbm_bytes=8e10)
    ref_hw = ref_roofline.HW(**dataclasses.asdict(hw))
    assert _terms(roofline_from_artifact(art, hw)) == \
        _terms(ref_roofline.roofline_from_artifact(art, ref_hw))
    assert dataclasses.asdict(HW()) == dataclasses.asdict(ref_roofline.HW())


def test_roofline_terms_and_dominance():
    """tests/test_roofline.py:44-54 on the port."""
    art = {"chips": 256,
           "cost": {"flops": 197e12, "bytes accessed": 819e9 * 2},
           "collectives": {"all-reduce": int(50e9 * 0.5), "count": 3}}
    t = roofline_from_artifact(art)
    assert t.compute_s == pytest.approx(1.0)
    assert t.memory_s == pytest.approx(2.0)
    assert t.collective_s == pytest.approx(0.5)
    assert t.dominant == "memory"
    assert t.step_time_s == pytest.approx(2.0)


# ---- the transformer-step model ------------------------------------------------

@pytest.mark.parametrize("shape", list(REF_SHAPES))
@pytest.mark.parametrize("arch", REF_ARCH_IDS)
def test_estimate_equals_the_references_for_every_schedule(arch, shape):
    """All 60 schedules of the genome, every cost term equal."""
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    for s in SCHEDULES:
        got = estimate(cfg, SHAPES[shape], s)
        ref = ref_tpu_model.estimate(ref_cfg, REF_SHAPES[shape],
                                     _ref_schedule(s))
        assert dataclasses.asdict(got) == dataclasses.asdict(ref), s
        assert (got.step_s, got.edp, got.dominant) == \
            (ref.step_s, ref.edp, ref.dominant)


def test_estimate_equals_the_references_off_the_defaults():
    cfg, ref_cfg = get_config("dbrx-132b"), ref_get_config("dbrx-132b")
    kw = dict(chips=64, data_par=8, model_par=8)
    hw = HW(peak_flops=4e14, hbm_bw=1.6e12, ici_bw=1e11, hbm_bytes=3.2e10)
    ref_hw = ref_roofline.HW(**dataclasses.asdict(hw))
    for s in SCHEDULES[::7]:
        got = estimate(cfg, SHAPES["train_4k"], s, hw=hw, **kw)
        ref = ref_tpu_model.estimate(ref_cfg, REF_SHAPES["train_4k"],
                                     _ref_schedule(s), hw=ref_hw, **kw)
        assert dataclasses.asdict(got) == dataclasses.asdict(ref)


def test_schedule_genome_is_the_references():
    assert (REMAT_OPTIONS, MICROBATCH_OPTIONS, SHARDING_OPTIONS) == (
        ref_tpu_model.REMAT_OPTIONS, ref_tpu_model.MICROBATCH_OPTIONS,
        ref_tpu_model.SHARDING_OPTIONS)
    for s in SCHEDULES:
        assert [dataclasses.asdict(m) for m in s.mutate_options()] == \
            [dataclasses.asdict(m)
             for m in _ref_schedule(s).mutate_options()]
    problem = TpuScheduleProblem(get_config("qwen2-7b"), SHAPES["train_4k"])
    assert list(problem.enumerate()) == SCHEDULES
    assert problem.space_size() == len(SCHEDULES) == 60


def test_tpu_cost_model_remat_tradeoff():
    """tests/test_roofline.py:72-80 on the port."""
    cfg = get_config("qwen2-7b")
    shape = SHAPES["train_4k"]
    none = estimate(cfg, shape, TpuSchedule(remat="none"))
    full = estimate(cfg, shape, TpuSchedule(remat="full"))
    assert full.compute_s > none.compute_s          # recompute costs flops
    assert full.hbm_resident_bytes < none.hbm_resident_bytes
    mb = estimate(cfg, shape, TpuSchedule(microbatches=8))
    assert mb.hbm_resident_bytes < none.hbm_resident_bytes


def test_tpu_cost_model_compression_cuts_collectives():
    """tests/test_roofline.py:83-88 on the port."""
    cfg = get_config("qwen2-7b")
    shape = SHAPES["train_4k"]
    raw = estimate(cfg, shape, TpuSchedule())
    gc = estimate(cfg, shape, TpuSchedule(grad_compression=True))
    assert gc.collective_s < raw.collective_s


def test_tpu_ga_finds_feasible_schedule_for_giant_model():
    """tests/test_roofline.py:91-98 on the port."""
    cfg = get_config("llama4-maverick-400b-a17b")
    res = optimize_tpu_schedule(cfg, SHAPES["train_4k"],
                                ga=GAConfig.fast(generations=15, seed=0))
    assert res.baseline_cost.hbm_resident_bytes > 16e9
    assert res.best_cost.hbm_resident_bytes <= 16e9
    assert res.best.microbatches > 1 or res.best.remat != "none"


def test_tpu_ga_monotone_history():
    """tests/test_roofline.py:101-106 on the port."""
    cfg = get_config("dbrx-132b")
    res = optimize_tpu_schedule(cfg, SHAPES["train_4k"],
                                ga=GAConfig.fast(generations=10, seed=1))
    h = res.history
    assert all(b >= a - 1e-12 for a, b in zip(h, h[1:]))


def test_tpu_ga_selects_fsdp_for_dense_tp_for_moe():
    """tests/test_report.py:28-39 on the port."""
    dense = optimize_tpu_schedule(get_config("stablelm-1.6b"),
                                  SHAPES["train_4k"],
                                  ga=GAConfig.fast(generations=20, seed=0))
    assert dense.best.sharding == "fsdp"
    moe = optimize_tpu_schedule(get_config("dbrx-132b"), SHAPES["train_4k"],
                                ga=GAConfig.fast(generations=20, seed=0))
    assert moe.best.sharding == "tp"
    assert moe.best_cost.hbm_resident_bytes <= 16e9


# ---- the schedule search, every backend --------------------------------------------

def _result(r) -> dict:
    return dict(best=dataclasses.asdict(r.best),
                best_cost=dataclasses.asdict(r.best_cost),
                baseline=dataclasses.asdict(r.baseline),
                baseline_cost=dataclasses.asdict(r.baseline_cost),
                history=list(r.history), evaluations=r.evaluations,
                edp_improvement=r.edp_improvement,
                step_improvement=r.step_improvement)


SCHEDULE_SEARCHES = {
    "ga_qwen_defaults": dict(arch="qwen2-7b", shape="train_4k"),
    "ga_llama4_seed3": dict(arch="llama4-maverick-400b-a17b",
                            shape="train_4k", seed=3, generations=12),
    "ga_whisper_step": dict(arch="whisper-small", shape="prefill_32k",
                            objective="step", seed=2, generations=8),
    "ga_preset_config": dict(arch="falcon-mamba-7b", shape="decode_32k",
                             backend_config={"preset": "fast",
                                             "generations": 5}),
    "random": dict(arch="dbrx-132b", shape="train_4k", backend="random",
                   seed=4, backend_config={"evaluations": 25}),
    "hill_climb": dict(arch="starcoder2-3b", shape="train_4k",
                       backend="hill_climb", seed=1),
    "exhaustive": dict(arch="stablelm-1.6b", shape="long_500k",
                       backend="exhaustive", hbm_capacity=8e9),
    "exhaustive_chips": dict(arch="recurrentgemma-2b", shape="train_4k",
                             backend="exhaustive", chips=64, data_par=8,
                             model_par=8, objective="step"),
}


@pytest.mark.parametrize("name", list(SCHEDULE_SEARCHES))
def test_search_tpu_schedule_equals_the_references(name):
    kw = dict(SCHEDULE_SEARCHES[name])
    arch, shape = kw.pop("arch"), kw.pop("shape")
    seed, gens = kw.pop("seed", 0), kw.pop("generations", 30)
    got = search_tpu_schedule(get_config(arch), SHAPES[shape],
                              ga=GAConfig.fast(generations=gens, seed=seed),
                              **kw)
    from repro.core.ga import GAConfig as RefGAConfig
    ref = ref_search_tpu(ref_get_config(arch), REF_SHAPES[shape],
                         ga=RefGAConfig.fast(generations=gens, seed=seed),
                         **kw)
    assert _result(got) == _result(ref)


@pytest.mark.parametrize("arch,seed", [("qwen2-7b", 0), ("dbrx-132b", 5)])
def test_optimize_tpu_schedule_equals_the_references(arch, seed):
    from repro.core.ga import GAConfig as RefGAConfig
    from repro.core.tpu_ga import optimize_tpu_schedule as ref_optimize
    got = optimize_tpu_schedule(get_config(arch), SHAPES["train_4k"],
                                ga=GAConfig.fast(generations=12, seed=seed))
    ref = ref_optimize(ref_get_config(arch), REF_SHAPES["train_4k"],
                       ga=RefGAConfig.fast(generations=12, seed=seed))
    assert _result(got) == _result(ref)


def test_chip_smoke_tpu_schedule_golden_is_the_references():
    """TPU_SCHEDULE_RUN (phase 6's host-only search) is the reference's
    result for its cell with the defaults, and the port's too."""
    run = _chip_smoke().TPU_SCHEDULE_RUN
    ref = ref_search_tpu(ref_get_config(run["arch"]),
                         REF_SHAPES[run["shape"]])
    want = dict(best=dataclasses.asdict(ref.best),
                edp_improvement=ref.edp_improvement,
                energy_j=ref.best_cost.energy_j,
                evaluations=ref.evaluations, history_len=len(ref.history))
    assert want == run["golden"]
    got = search_tpu_schedule(get_config(run["arch"]), SHAPES[run["shape"]])
    assert _result(got) == _result(ref)


# ---- the fusion-side TPU cost model ---------------------------------------------

def test_tpu_costmodel_is_registered_with_the_references_constants():
    from repro.costmodel import tpu_fusion as ref_tpu_fusion
    from repro_torch.costmodel import tpu_fusion
    assert COSTMODELS.get("tpu") is TpuFusionCostModel
    assert (tpu_fusion.VMEM_BYTES, tpu_fusion.TPU_CLOCK_MHZ) == (
        ref_tpu_fusion.VMEM_BYTES, ref_tpu_fusion.TPU_CLOCK_MHZ)
    from repro_torch.costmodel import tpu_model
    assert (tpu_model.E_FLOP_J, tpu_model.E_HBM_J_PER_BYTE,
            tpu_model.E_ICI_J_PER_BYTE) == (
        ref_tpu_model.E_FLOP_J, ref_tpu_model.E_HBM_J_PER_BYTE,
        ref_tpu_model.E_ICI_J_PER_BYTE)


@pytest.mark.parametrize("flags", [(True, True, 1), (False, True, 1),
                                   (True, False, 3), (False, False, 0)])
def test_cost_layer_equals_the_references(flags):
    inputs_off, outputs_off, passes = flags
    g, rg = mobilenet_v3_large(), ref_mobilenet()
    cm, rcm = TpuFusionCostModel(g, SIMBA), RefTpuFusion(rg, REF_SIMBA)
    for name in g.layers:
        got = cm.cost_layer(g.layers[name], inputs_offchip=inputs_off,
                            outputs_offchip=outputs_off,
                            weight_stream_passes=passes)
        ref = rcm.cost_layer(rg.layers[name], inputs_offchip=inputs_off,
                             outputs_offchip=outputs_off,
                             weight_stream_passes=passes)
        assert vars(got) == vars(ref), name


def test_group_costs_equal_the_references():
    """Every fused run of up to 4 consecutive nodes of mobilenet_v3, and
    the whole graph: the same breakdown, or None (VMEM exceeded) for
    both."""
    g, rg = mobilenet_v3_large(), ref_mobilenet()
    ev = Evaluator(g, SIMBA, costmodel=TpuFusionCostModel, device="cpu")
    rev = RefEvaluator(rg, REF_SIMBA, costmodel=RefTpuFusion)
    names = g.names
    for k in (1, 2, 3, 4):
        for i in range(len(names) - k + 1):
            key = frozenset(names[i:i + k])
            got = ev.costmodel.cost_group(key)
            ref = rev.costmodel.cost_group(key)
            assert (got is None) == (ref is None), key
            if got is not None:
                assert dataclasses.asdict(got) == dataclasses.asdict(ref)


def test_tpu_model_fusion_saves_hbm_traffic():
    """tests/test_costmodel_protocol.py:111-122 on the port."""
    g = _chain(4)
    ev = Evaluator(g, SIMBA, costmodel=TpuFusionCostModel, device="cpu")
    base = ev.layerwise()
    fused = ev.evaluate(FusionState.fully_fused(g))
    assert fused is not None
    assert fused.energy_pj < base.energy_pj

    def total(c):
        return c.dram_read_words + c.dram_write_words

    assert total(fused) < total(base)
    assert fused.macs == base.macs
    assert base.clock_hz == pytest.approx(940e6)


def test_tpu_model_vmem_capacity_invalidates_giant_tiles():
    """tests/test_costmodel_protocol.py:125-135 on the port."""
    g = LayerGraph("huge")
    i = g.add(Layer(name="input", kind="input", m=2048, p=1024, q=1024))
    a = g.add(Layer(name="a", kind="conv", c=2048, h=1024, w=1024, m=2048,
                    p=1024, q=1024, r=3, s=3, padding=(1, 1)), [i])
    g.add(Layer(name="b", kind="conv", c=2048, h=1024, w=1024, m=2048,
                p=1024, q=1024, r=3, s=3, padding=(1, 1)), [a])
    ev = Evaluator(g, SIMBA, costmodel=TpuFusionCostModel, device="cpu")
    assert ev.evaluate(FusionState.fully_fused(g)) is None
    assert ev.fitness(FusionState.fully_fused(g)) == 0.0


def test_tpu_model_evaluations_equal_the_references():
    """tests/test_costmodel_protocol.py:138-147 holds the bitmask engine to
    the reference engine (``fusion_ref``, not ported: the port holds its
    engine to the reference's); here the port's evaluations equal the
    reference's, state by state."""
    from repro.core.fusion import FusionState as RefState
    from tests.test_fusion import chain as ref_chain
    g, rg = _chain(5), ref_chain(5)
    ev = Evaluator(g, SIMBA, costmodel=TpuFusionCostModel, device="cpu")
    rev = RefEvaluator(rg, REF_SIMBA, costmodel=RefTpuFusion)
    for fused in (frozenset(), frozenset({("c0", "c1")}),
                  frozenset(g.edges)):
        got = ev.evaluate(FusionState(g, fused))
        ref = rev.evaluate(RefState(rg, fused))
        assert dataclasses.asdict(got) == dataclasses.asdict(ref)


def test_cli_costmodel_tpu_end_to_end(tmp_path, capsys):
    """tests/test_costmodel_protocol.py:150-157 on the port."""
    from repro_torch.__main__ import main
    out = tmp_path / "tpu.json"
    rc = main(["search", "--workload", "mobilenet_v3", "--accelerator",
               "flexnn", "--costmodel", "tpu", "--backend", "ga",
               "--preset", "fast", "--generations", "3", "--out", str(out),
               "--device", "cpu"])
    assert rc == 0
    data = json.loads(out.read_text())
    assert data["spec"]["costmodel"] == "tpu"
    assert data["group_breakdowns"], "artifact must store breakdowns"
    assert main(["report", str(out), "--breakdown"]) == 0
    assert main(["search", "--workload", "mobilenet_v3", "--costmodel",
                 "nope", "--device", "cpu"]) == 2
    assert "unknown costmodel" in capsys.readouterr().err


# ---- tpu CNN searches: whole artifacts --------------------------------------------

TPU_SEARCHES = {
    "ga_fast": dict(workload="mobilenet_v3", accelerator="simba",
                    costmodel="tpu", backend="ga", seed=0,
                    backend_config={"preset": "fast", "generations": 8}),
    "ga_energy": dict(workload="resnet50", accelerator="eyeriss",
                      costmodel="tpu", backend="ga", seed=1,
                      objective="energy",
                      backend_config={"preset": "fast", "generations": 6}),
    "random": dict(workload="vgg16", accelerator="simba", costmodel="tpu",
                   backend="random", seed=2,
                   backend_config={"evaluations": 2000}),
    "hill_climb": dict(workload="mobilenet_v3", accelerator="flexnn",
                       costmodel="tpu", backend="hill_climb", seed=0,
                       objective="dram", backend_config={"max_steps": 5}),
    "exhaustive_spacemap": dict(workload="unet", accelerator="simba",
                                costmodel="tpu", backend="exhaustive",
                                spacemap=True, workload_kwargs={"depth": 1}),
    "ga_spacemap": dict(workload="vgg16", accelerator="simba",
                        costmodel="tpu", backend="ga", seed=3,
                        spacemap=True,
                        backend_config={"preset": "fast",
                                        "generations": 6}),
}


@pytest.mark.parametrize("name", list(TPU_SEARCHES))
def test_tpu_artifact_equals_the_references(name):
    """The whole artifact (genome, fitness, history, costs, per-group
    breakdowns, spacemap) and its store key."""
    kw = TPU_SEARCHES[name]
    ref = ref_search(**kw)
    got = search(**kw, device="cpu")
    assert _comparable(got) == _comparable(ref)
    assert artifact_key(got.graph_fingerprint, got.spec) == \
        artifact_key(ref.graph_fingerprint, got.spec)
    from repro.serve.store import artifact_key as ref_key
    assert artifact_key(got.graph_fingerprint, got.spec) == \
        ref_key(ref.graph_fingerprint, ref.spec)


def test_chip_smoke_tpu_ga_golden_is_the_references():
    """TPU_GA_RUN (phase 6: the paper's GA under the tpu cost model) is the
    reference's result, on the population engine, and the port's CPU path
    gives its whole artifact and store key."""
    run = _chip_smoke().TPU_GA_RUN
    ref = ref_search(**run["spec"])
    assert dict(genome_mask=ref.genome_mask, best_fitness=ref.best_fitness,
                evaluations=ref.evaluations) == run["golden"]
    assert ref.backend_stats["pop_batches"] > 0
    got = search(**run["spec"], device="cpu")
    assert got.backend_stats["pop_backend"] == "torch"
    assert got.backend_stats["pop_batches"] == \
        ref.backend_stats["pop_batches"]
    assert _comparable(got) == _comparable(ref)
    from repro.serve.store import artifact_key as ref_key
    assert artifact_key(got.graph_fingerprint, got.spec) == \
        ref_key(ref.graph_fingerprint, ref.spec)


def test_tpu_artifacts_verify_in_both_packages():
    """The verifier reads the tpu capacity (VMEM) as the reference's does:
    the port's artifact and the reference's verify, with equal
    certificates."""
    from repro.analysis import verify_artifact as ref_verify
    from repro.search import ScheduleArtifact as RefArtifact
    from repro_torch.analysis import onchip_words_for, verify_artifact
    from repro_torch.search import ScheduleArtifact
    from repro.analysis.bounds import onchip_words_for as ref_onchip
    kw = TPU_SEARCHES["ga_fast"]
    mine = search(**kw, device="cpu")
    ref = ref_search(**kw)
    assert onchip_words_for("tpu", "simba") == ref_onchip("tpu", "simba")
    for art in (mine, ScheduleArtifact.from_json(ref.to_json())):
        report = verify_artifact(art)
        assert report.ok, report.describe()
        want = ref_verify(RefArtifact.from_json(art.to_json()))
        assert report.describe() == want.describe()
