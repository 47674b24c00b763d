"""The port's step timer and profiling tools (icek_torch/utils/profiling.py,
icek_torch/tools/): ``StepTimer`` against JAX's under one clock, and the
tools' summary of a CPU ``torch.profiler`` trace of a tiny train step (the
host's operators, by self time) and of a device trace's kernel names."""

import json
import os
import time

import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from icek_torch.tools import profile_eval, profile_train_step as pts
from icek_torch.utils import profiling as tprof
from icek_tpu.utils import profiling as jprof


def test_step_timer_equals_jax(monkeypatch):
    ticks = [0.0, 0.5, 2.0, 2.25, 4.0, 4.125, 7.0]
    summaries = []
    for mod in (jprof, tprof):
        clock = iter(ticks)
        monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
        timer = mod.StepTimer()
        for _ in range(3):
            timer.data_ready()
            timer.step_done()
        summaries.append(timer.summary())
        monkeypatch.undo()
    assert summaries[0] == summaries[1]
    assert summaries[1] == {"steps": 3, "avg_data_ms": 1000.0 * 0.875 / 3,
                            "avg_step_ms": 1000.0 * 6.125 / 3}
    assert tprof.StepTimer().summary() == jprof.StepTimer().summary()


@pytest.mark.parametrize("name,cls", [
    ("void (anonymous namespace)::flash_fwd_mma_kernel<4>(Shape)", "flash_fwd"),
    ("void (anonymous namespace)::flash_bwd_dkv_mma_kernel<2>(...)", "flash_bwd"),
    ("void (anonymous namespace)::score_partial_mma_kernel<...>", "score_topk"),
    ("score_merge_kernel", "score_topk"),
    ("void (anonymous namespace)::decoder_step_mma_kernel<2>(Args)", "decoder_step"),
    ("void (anonymous namespace)::ln_fwd_span_kernel<16, 5>(...)", "ln_fwd"),
    ("ln_bwd_reduce_kernel", "ln_bwd"),
    ("void (anonymous namespace)::dropout_flat_kernel<__nv_bfloat16>(...)", "dropout"),
    ("int8_conv_kernel<3>", "int8_conv"),
    ("void at::native::indexing_backward_kernel<c10::BFloat16, 4>(...)",
     "indexing_backward"),
    ("fmha_cutlassF_bf16_aligned_64x64_rf_sm80", "attention"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64", "gemm"),
    ("void at::native::vectorized_elementwise_kernel<4, ...>", "elementwise"),
    ("Memcpy DtoD (Device -> Device)", "copy"),
    ("aten::mm", "gemm"), ("aten::softmax", "attention"), ("aten::copy_", "copy"),
    ("aten::add_", "elementwise"), ("Optimizer.step#Adam.step", "other"),
])
def test_op_classes(name, cls):
    assert pts.op_class(name) == cls


@pytest.fixture(scope="module")
def cpu_trace(tmp_path_factory):
    """A torch.profiler trace of two tiny train steps on the CPU."""
    from icek_torch import bridge
    from icek_torch.train import step as tstep
    import test_torch_train as tt

    jc, tc = tt._cfgs(layers=1)
    params = bridge.trainable(bridge.from_jax_params(
        tt.jax_params_numpy(jc.model, tt.V, 0), tc.model, tt.V), "cpu")
    opt = tstep.make_optimizer(1e-3)
    state = opt.init(params)
    train, _ = tstep.make_train_step(tc, tt.V, 0, opt, encode_images=False, device="cpu")
    batch, gen = tt._batch(4), torch.Generator().manual_seed(0)
    d = tmp_path_factory.mktemp("trace")
    return pts.trace(lambda: train(params, state, None, batch, gen), str(d), steps=2)


def test_cpu_trace_summary(cpu_trace):
    lines = []
    assert pts.find_trace(os.path.dirname(cpu_trace)) == cpu_trace
    total, rows = pts.summarize(cpu_trace, 2, out=lines.append)
    classes = dict(rows)
    assert {"gemm", "elementwise", "copy", "attention", "indexing_backward"} <= set(classes)
    assert total > 0 and abs(sum(ms for ms, _ in classes.values()) - total) < 1e-6
    assert lines[0].startswith("host total:") and "ms/step attributed" in lines[0]
    assert lines[1].split() == ["op", "class", "total", "ms", "ms/step", "count"]
    # self times: a caller's time excludes its callees', so nothing counts twice
    source, ops = pts.trace_ops(cpu_trace)
    assert source == "host" and all(ms >= -1e-3 for _, ms in ops)
    top = profile_eval.top_ops(cpu_trace, 5, out=lines.append)
    assert len(top) == 5 and top[0][1] >= top[-1][1] > 0
    assert any(name in ("aten::mm", "aten::bmm", "aten::addmm") for name, _, _ in top)


def test_device_trace_summary(tmp_path):
    """A trace with kernel events is summarized from them alone, host
    operators left out."""
    events = [
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0, "dur": 900, "pid": 1,
         "tid": 1},
        {"ph": "X", "cat": "kernel", "name": "sm90_xmma_gemm_bf16", "ts": 10, "dur": 400,
         "pid": 0, "tid": 7},
        {"ph": "X", "cat": "kernel", "name": "void (anonymous namespace)::ln_fwd_kernel<>",
         "ts": 500, "dur": 100, "pid": 0, "tid": 7},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pageable -> Device)",
         "ts": 700, "dur": 50, "pid": 0, "tid": 7},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    lines = []
    total, rows = pts.summarize(str(path), 1, out=lines.append)
    assert total == pytest.approx(0.55)
    assert [(k, v[1]) for k, v in rows] == [("gemm", 1), ("ln_fwd", 1), ("copy", 1)]
    assert lines[0].startswith("device total:")
    top = profile_eval.top_ops(str(path), 2, out=lines.append)
    assert [t[0] for t in top] == ["sm90_xmma_gemm_bf16",
                                   "void (anonymous namespace)::ln_fwd_kernel<>"]
    with pytest.raises(FileNotFoundError):
        pts.find_trace(str(tmp_path / "none"))
