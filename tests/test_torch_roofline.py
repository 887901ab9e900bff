"""The port's roofline (`utils/roofline.py`, over torch.profiler traces)
against the reference's (over jax.profiler's "XLA Ops" track), and the
shared bytes and FLOPs formulas of K1-K4.

- Twin crafted traces from one seeded table of operators and their
  kernels: the reference's format (one "XLA Ops" event per kernel with
  XLA's `bytes_accessed`, `model_flops`, `device_duration_ps` and
  `hlo_category`) and torch's (CPU ops with `Input Dims`, `Input type`,
  `Input Strides`, `Concrete Inputs` and `External id`; kernel, copy and
  fill events carrying the External id of the operator that launched
  them). The torch trace comes in both shapes a torch version may write:
  kernels linked to the innermost operator, or to the outermost one (a
  `aten::linear` around its `aten::addmm`, and K2's forward under
  `torch.library.custom_op`'s generated autograd Function, as torch 2.11
  records it on the card); one kernel is linked only
  through its runtime call's correlation, and one to no operator. The
  reference's bytes are what the port's rules must give (computed here
  from the dims, or from the kernels' cost functions); then totals,
  per-op stats, `by_category_ms`, `clawback`, `--dispatches`, `--json`
  and `format_report` (with "MXU" read as "tensor-core") are equal.
- A real CPU capture of a tiny LM step through `utils/perf.maybe_trace`
  (the LM benchmark's `profile_dir`): the loader reads torch's own format,
  and `aten::mm`'s bytes follow from its recorded dims.
- The missing-trace error.
- The shared formulas reproduce PERF.md §6's bounds.
"""

import gzip
import json
import math
import os

import numpy as np
import pytest

from tritonk8ssupervisor_tpu.utils import roofline as ref_roofline
from tritonk8ssupervisor_tpu_torch.ops import conv_backward as cb
from tritonk8ssupervisor_tpu_torch.ops import cross_entropy as ce
from tritonk8ssupervisor_tpu_torch.ops import decode_attention as da
from tritonk8ssupervisor_tpu_torch.ops import flash_attention as fa
from tritonk8ssupervisor_tpu_torch.ops.flash_attention_cuda import dims as attention_dims
from tritonk8ssupervisor_tpu_torch.utils import perf, roofline

PEAK_BYTES, PEAK_FLOPS = 3.35e12, 989e12
BF16, F32, I32 = "c10::BFloat16", "float", "int"
SIZES = {BF16: 2, F32: 4, I32: 4, "bool": 1}


def _contiguous(dims):
    strides, step = [], 1
    for d in reversed(dims):
        strides.insert(0, step)
        step *= d
    return strides


def operators(seed: int) -> list[dict]:
    """One step's operators drawn from a seed: each with its inputs
    (dims, dtype[, strides]), concrete inputs, the bytes and FLOPs the
    port's rules must give it, and its kernels' names and µs."""
    rng = np.random.default_rng(seed)

    def dim(lo, hi):
        return int(rng.integers(lo, hi)) * 64

    def us(lo=5, hi=400):
        return int(rng.integers(lo, hi))

    ops = []
    for layer in range(3):
        m, k, n = dim(16, 64), dim(4, 16), dim(4, 24)
        ops.append({
            "name": "aten::addmm", "outer": "aten::linear",
            "inputs": [([n], BF16), ([m, k], BF16), ([k, n], BF16, [1, k])],
            "outer_inputs": [([m, k], BF16), ([n, k], BF16), ([n], BF16)],
            "bytes": 2 * (n + m * k + k * n + m * n), "flops": 2.0 * m * n * k,
            "kernels": [(f"sm90_xmma_gemm_bf16bf16_{layer}", us(50, 600))]})
        ops.append({
            "name": "aten::mm", "inputs": [([m, n], BF16), ([n, k], BF16)],
            "bytes": 2 * (m * n + n * k + m * k), "flops": 2.0 * m * k * n,
            "kernels": [(f"sm90_xmma_gemm_splitk_{layer}", us(20, 300)),
                        (f"splitKreduce_kernel_{layer}", us(2, 20))]})
        ops.append({
            "name": "aten::add", "inputs": [([m, n], BF16), ([n], BF16), ([], "long int")],
            "bytes": 2 * (m * n + n) + 8 + 2 * m * n, "flops": 0.0,
            "kernels": [(f"vectorized_elementwise_add_{layer}", us())]})
        ops.append({
            "name": "aten::copy_", "inputs": [([m, k], BF16), ([m, k], F32)],
            "bytes": 4 * m * k + 2 * m * k, "flops": 0.0,
            "kernels": [(f"unrolled_elementwise_copy_{layer}", us())]})
        ops.append({  # a broadcast fill: the stride-0 source is read once
            "name": "aten::copy_", "inputs": [([m, n], F32), ([m, n], F32, [0, 1])],
            "bytes": 4 * n + 4 * m * n, "flops": 0.0,
            "kernels": [(f"broadcast_copy_{layer}", us(2, 40))]})
        ops.append({"name": "aten::native_layer_norm",
                    "inputs": [([m, k], BF16), ([k], F32), ([k], F32)],
                    "bytes": 0, "flops": 0.0,
                    "kernels": [(f"layer_norm_kernel_{layer}", us())]})
    b, s, h, d = int(rng.integers(1, 9)), dim(4, 17), int(rng.integers(2, 13)), 64
    rows, vocab = b * s, dim(64, 513)
    ops += [
        {"name": "tk8s::flash_attn_fwd", "concrete": ["", "", "", "True", ""],
         "inputs": [([b, s, h, d], BF16)] * 3 + [([], "Scalar"), ([], "")],
         "cost": fa.forward_cost(b, h, s, d, True, 2),
         "kernels": [("attn_fwd", us(100, 900))]},
        {"name": "tk8s::flash_attn_bwd", "concrete": ["", "", "", "", "", "", "True", ""],
         "inputs": [([b, s, h, d], BF16)] * 5 + [([b, h, s], F32), ([], "Scalar"), ([], "")],
         "cost": fa.backward_cost(b, h, s, d, True, 2),
         "kernels": [("attn_bwd_rows", us(10, 60)), ("attn_bwd_dkdv", us(200, 900)),
                     ("attn_bwd_dq", us(150, 700))]},
        {"name": "tk8s::cross_entropy_fwd", "inputs": [([rows, vocab], BF16), ([rows], I32)],
         "cost": ce.forward_cost(rows, vocab, 2, 4), "kernels": [("ce_fwd_cta", us(20, 200))]},
        {"name": "tk8s::cross_entropy_bwd",
         "inputs": [([rows, vocab], BF16), ([rows], I32), ([rows], F32), ([rows], F32, [0])],
         "cost": ce.backward_cost(rows, vocab, 2, 4), "kernels": [("ce_bwd", us(40, 400))]},
        {"name": "tk8s::conv1x1_bwd",
         "inputs": [([rows, 256], BF16), ([rows, 64], BF16), ([64, 256], BF16)],
         "cost": cb.backward_cost(rows, 256, 64, 2),
         "kernels": [("dgrad", us(50, 300)), ("wgrad", us(50, 300)), ("reduce", us(2, 9))]},
        {"name": "aten::zero_", "inputs": [([rows, 64], F32)], "bytes": 4 * rows * 64,
         "flops": 0.0, "kernels": [("Memset (Device)", us(1, 9), "gpu_memset")]},
    ]
    for op in ops:
        if "cost" in op:
            op["bytes"], op["flops"] = map(float, op["cost"])
    return ops


def torch_trace(ops: list[dict], link: str) -> dict:
    """The step as torch.profiler writes it. `link` is "inner" (kernels
    carry the innermost operator's External id) or "outer"."""
    events, ext, corr, ts = [], 0, 0, 1000.0

    def cpu_op(name, inputs, concrete=None):
        nonlocal ext
        ext += 1
        events.append({
            "ph": "X", "cat": "cpu_op", "name": name, "pid": 1, "tid": 1, "ts": ts, "dur": 5,
            "args": {"External id": ext, "Record function id": 0,
                     "Input Dims": [i[0] for i in inputs], "Input type": [i[1] for i in inputs],
                     "Input Strides": [i[2] if len(i) > 2 else
                                       (_contiguous(i[0]) if i[1] in SIZES else [])
                                       for i in inputs],
                     "Concrete Inputs": concrete or [""] * len(inputs)}})
        return ext

    for index, op in enumerate(ops):
        outer = cpu_op(op["outer"], op["outer_inputs"]) if "outer" in op else None
        if link == "outer" and op["name"] == "tk8s::flash_attn_fwd":
            # as torch 2.11 records it: custom_op's autograd Function, with
            # q, k, v and causal
            inner = cpu_op("GeneratedBackwardFor_tk8s_flash_attn_fwd_default",
                           op["inputs"][:4], op["concrete"][:4])
        else:
            inner = cpu_op(op["name"], op["inputs"], op.get("concrete"))
        target = outer if link == "outer" and outer else inner
        for j, (kernel, dur, *cat) in enumerate(op["kernels"]):
            corr += 1
            args = {"External id": target, "correlation": corr, "stream": 7}
            if index == 1 and j == 0:  # linked only through its runtime call
                del args["External id"]
            events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                           "pid": 1, "tid": 1, "ts": ts, "dur": 3,
                           "args": {"External id": target, "correlation": corr}})
            events.append({"ph": "X", "cat": (cat or ["kernel"])[0], "name": kernel,
                           "pid": 0, "tid": 7, "ts": ts + 10, "dur": dur, "args": args})
            ts += dur + 1
    # a kernel no operator launched (e.g. from a library's own thread)
    events.append({"ph": "X", "cat": "kernel", "name": "ncclDevKernel_orphan", "pid": 0,
                   "tid": 7, "ts": ts, "dur": 17, "args": {"External id": 10**6}})
    return {"schemaVersion": 1, "record_shapes": 1, "traceEvents": events}


def xla_trace(ops: list[dict], link: str) -> dict:
    """The same step as the reference's profile: one "XLA Ops" event per
    kernel, the operator's bytes and FLOPs shared by device time."""
    events = [{"ph": "M", "name": "thread_name", "pid": 1, "tid": 2,
               "args": {"name": "XLA Ops"}}]
    for op in ops:
        spent = sum(k[1] for k in op["kernels"])
        category = op["outer"] if link == "outer" and "outer" in op else op["name"]
        for kernel, dur, *_ in op["kernels"]:
            share = dur / spent
            events.append({"ph": "X", "name": kernel, "pid": 1, "tid": 2, "ts": 0, "dur": dur,
                           "args": {"device_duration_ps": dur * 1e6,
                                    "bytes_accessed": op["bytes"] * share,
                                    "model_flops": op["flops"] * share,
                                    "hlo_category": category}})
    events.append({"ph": "X", "name": "ncclDevKernel_orphan", "pid": 1, "tid": 2, "ts": 0,
                   "dur": 17, "args": {"device_duration_ps": 17e6,
                                       "hlo_category": roofline.NO_OPERATOR}})
    return {"traceEvents": events}


def _stats(report) -> list:
    return [[op.name, op.category, op.duration_ms, op.bytes_accessed, op.flops,
             op.occurrences] for op in report.ops]


def _summary(report) -> dict:
    return {
        "total_ms": report.total_ms, "total_bytes": report.total_bytes,
        "total_flops": report.total_flops, "ops": _stats(report),
        "by_category_ms": report.by_category_ms,
        "clawback": [op.name for op in report.clawback()],
        "bounds": [report.hbm_bound_ms, report.mxu_bound_ms, report.hbm_efficiency],
        "text": format_text(report),
    }


def format_text(report) -> str:
    return roofline.format_report(report, top=40)


@pytest.fixture
def twins(tmp_path):
    def write(seed, link):
        ops = operators(seed)
        port_dir, ref_dir = tmp_path / f"port-{seed}-{link}", tmp_path / f"ref-{seed}-{link}"
        port_dir.mkdir()
        (ref_dir / "plugins" / "profile" / "run").mkdir(parents=True)
        (port_dir / "trace.json").write_text(json.dumps(torch_trace(ops, link)))
        with gzip.open(ref_dir / "plugins" / "profile" / "run" / "host.trace.json.gz",
                       "wt") as f:
            json.dump(xla_trace(ops, link), f)
        return str(port_dir), str(ref_dir)
    return write


@pytest.mark.parametrize("link", ["inner", "outer"])
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("dispatches", [1, 2])
def test_report_equals_the_reference_s_on_the_same_step(twins, seed, link, dispatches):
    port_dir, ref_dir = twins(seed, link)
    ours = roofline.analyze(port_dir, dispatches, PEAK_BYTES, PEAK_FLOPS)
    ref = ref_roofline.analyze(ref_dir, dispatches, PEAK_BYTES, PEAK_FLOPS)
    a, b = _summary(ours), _summary(ref)
    b["text"] = ref_roofline.format_report(ref, top=40).replace(
        "MXU roofline", "tensor-core roofline")
    assert a == b
    cats = ours.by_category_ms
    assert roofline.NO_OPERATOR in cats and "tk8s::flash_attn_bwd" in cats
    assert ("aten::linear" in cats) is (link == "outer")
    assert "tk8s::flash_attn_fwd" in cats and not [c for c in cats if "Generated" in c]
    assert ours.total_bytes > 0 and ours.total_flops > 0


def test_json_and_text_of_the_cli_equal_the_reference_s(twins, capsys):
    port_dir, ref_dir = twins(3, "inner")
    for flags in (["--json"], ["--top", "5"], ["--json", "--dispatches", "2"]):
        peaks = ["--peak-gbs", "3350", "--peak-tflops", "989"]
        assert roofline.main([port_dir, *flags, *peaks]) == 0
        ours = capsys.readouterr().out
        assert ref_roofline.main([ref_dir, *flags, *peaks]) == 0
        ref = capsys.readouterr().out.replace("MXU roofline", "tensor-core roofline")
        if "--json" in flags:
            ours, ref = json.loads(ours), json.loads(ref)
            assert set(ours) == {"total_ms", "total_gbytes", "total_tflops",
                                 "achieved_gbytes_per_sec", "hbm_bound_ms", "mxu_bound_ms",
                                 "hbm_efficiency", "by_category_ms", "clawback_ms"}
        assert ours == ref


def test_without_a_card_the_peaks_are_unknown(twins):
    port_dir, ref_dir = twins(4, "inner")
    ours, ref = roofline.analyze(port_dir), ref_roofline.analyze(ref_dir)
    assert ours.peak_bytes_per_sec is None and ours.peak_flops_per_sec is None
    assert ref.peak_bytes_per_sec is None and ref.peak_flops_per_sec is None
    assert ours.clawback() == [] and ours.hbm_bound_ms is None
    assert roofline.format_report(ours) == ref_roofline.format_report(ref)


def test_the_peak_tables_name_the_h100():
    assert roofline.peak_hbm_bytes_per_sec("NVIDIA H100 80GB HBM3") == 3.35e12
    assert roofline.peak_tensor_flops_per_sec("NVIDIA H100 80GB HBM3") == 989e12
    assert roofline.peak_hbm_bytes_per_sec("NVIDIA H100 PCIe 80GB") == 2.0e12  # prefix
    assert roofline.peak_hbm_bytes_per_sec("cpu") is None
    assert set(roofline.PEAK_HBM_BYTES) == set(perf.PEAK_BF16_FLOPS)
    assert set(roofline.PEAK_F32_FLOPS) == set(perf.PEAK_BF16_FLOPS)


def test_attention_layout_comes_from_the_backward_s_logsumexp():
    """K2's FLOPs need the sequence dim: the layout string is not recorded
    (torch writes "" for a str argument), so a forward learns it from the
    backward op on the same q dims; alone, it keeps its bytes and counts no
    FLOPs."""
    def op(name, dims, extra, concrete):
        inputs = [dims] * (3 if name.endswith("fwd") else 5) + extra
        return {"name": name, "args": {
            "Input Dims": inputs + [[], []],
            "Input type": [BF16] * (len(inputs) - len(extra)) + [F32] * len(extra)
            + ["Scalar", ""], "Concrete Inputs": concrete}}

    for layout, q in (("bshd", [2, 256, 4, 64]), ("bhsd", [2, 4, 256, 64])):
        b, h, s, d = attention_dims(q, layout)
        fwd = op("tk8s::flash_attn_fwd", q, [], ["", "", "", "True", ""])
        bwd = op("tk8s::flash_attn_bwd", q, [[b, h, s]], [""] * 6 + ["True", ""])
        layouts = roofline.attention_layouts([bwd])
        assert layouts == {tuple(q): layout}
        assert roofline.op_cost(fwd, layouts) == tuple(map(float, fa.forward_cost(
            b, h, s, d, True, 2)))
        assert roofline.op_cost(bwd, layouts) == tuple(map(float, fa.backward_cost(
            b, h, s, d, True, 2)))
        alone = roofline.op_cost(fwd)
        assert alone == (float(fa.forward_cost(b, h, s, d, True, 2)[0]), 0.0)
        named = op("tk8s::flash_attn_fwd", q, [], ["", "", "", "False", layout])
        assert roofline.op_cost(named) == tuple(map(float, fa.forward_cost(
            b, h, s, d, False, 2)))


def test_a_real_cpu_capture_of_a_tiny_lm_step(tmp_path):
    """The LM benchmark's `profile_dir` on the CPU: torch's own trace, with
    the shapes recorded. A CPU capture has no device events; kernels linked
    to its `aten::mm` operators are attributed their recorded dims' bytes."""
    from tritonk8ssupervisor_tpu_torch.benchmarks import lm

    profile = tmp_path / "profile"
    lm.run_benchmark(vocab_size=128, num_layers=1, num_heads=2, embed_dim=64, seq_len=32,
                     batch_per_data_shard=2, steps=1, warmup=1, windows=1,
                     profile_dir=str(profile), device="cpu")
    path = roofline.find_trace_file(str(profile))
    assert path == str(profile / "trace.json")
    assert roofline.find_trace_file(path) == path
    trace = json.loads(open(path).read())
    assert trace.get("record_shapes") and trace.get("with_flops")
    assert roofline.load_device_ops(path) == []
    empty = roofline.analyze(str(profile))
    assert (empty.total_ms, empty.total_bytes, empty.ops) == (0.0, 0.0, [])

    mms = [e for e in trace["traceEvents"]
           if e.get("cat") == "cpu_op" and e["name"] in ("aten::mm", "aten::addmm")]
    assert len(mms) >= 4
    for e in mms:
        dims, types = e["args"]["Input Dims"], e["args"]["Input type"]
        first = 0 if e["name"] == "aten::mm" else 1  # addmm's bias comes first
        a, b = dims[first], dims[first + 1]
        elem = roofline.ELEMENT_BYTES[types[first]]
        inputs = sum(math.prod(d) * roofline.ELEMENT_BYTES[t]
                     for d, t in zip(dims, types) if t in roofline.ELEMENT_BYTES)
        expected = inputs + a[0] * b[1] * elem, 2.0 * a[0] * b[1] * a[1]
        assert roofline.op_cost(e) == expected, e
    # kernels linked to the captured operators, as a card's trace has them
    for i, e in enumerate(mms):
        trace["traceEvents"].append({"ph": "X", "cat": "kernel", "name": f"gemm_{i % 2}",
                                     "pid": 0, "tid": 7, "ts": 0, "dur": 10 + i,
                                     "args": {"External id": e["args"]["External id"]}})
    linked = tmp_path / "linked.trace.json"
    linked.write_text(json.dumps(trace))
    report = roofline.analyze(str(tmp_path), peak_bytes_per_sec=PEAK_BYTES,
                              peak_flops_per_sec=PEAK_FLOPS)
    assert report.total_bytes == sum(roofline.op_cost(e)[0] for e in mms)
    assert report.total_ms == pytest.approx(sum(10 + i for i in range(len(mms))) / 1e3)
    assert set(report.by_category_ms) == {e["name"] for e in mms}


@pytest.mark.parametrize("side", [roofline, ref_roofline])
def test_no_trace_is_a_file_not_found_error(tmp_path, side):
    with pytest.raises(FileNotFoundError, match="--profile"):
        side.analyze(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        side.find_trace_file(os.path.join(str(tmp_path), "absent"))


def _k4_step_bound() -> float:
    shapes = [(56, 64, 64, 1), (56, 64, 256, 4), (56, 256, 64, 2), (56, 256, 128, 1),
              (28, 128, 512, 4), (28, 512, 128, 3), (28, 512, 256, 1),
              (14, 256, 1024, 6), (14, 1024, 256, 5), (14, 1024, 512, 1),
              (7, 512, 2048, 3), (7, 2048, 512, 2)]
    return sum(calls * roofline.bound_ms(*cb.backward_cost(256 * size * size, c, n, 2),
                                         PEAK_BYTES, PEAK_FLOPS)[0]
               for size, c, n, calls in shapes)


H100 = "NVIDIA H100 80GB HBM3"
F32_PEAK = roofline.PEAK_F32_FLOPS[H100]
# PERF.md §6's bounds (ms, to 4 places) and what sets them
BOUNDS = [
    ("K1 forward (8192, 32768) bf16", ce.forward_cost(8192, 32768, 2, 4), F32_PEAK,
     0.1603, "bytes"),
    ("K1 backward (8192, 32768) bf16", ce.backward_cost(8192, 32768, 2, 4), F32_PEAK,
     0.3205, "bytes"),
    ("K1 forward (256, 1000) f32", ce.forward_cost(256, 1000, 4, 4), F32_PEAK, 0.0003, "bytes"),
    ("K1 backward (256, 1000) f32", ce.backward_cost(256, 1000, 4, 4), F32_PEAK, 0.0006,
     "bytes"),
    ("K1 forward (32768, 256) bf16", ce.forward_cost(32768, 256, 2, 4), F32_PEAK, 0.0051,
     "bytes"),
    ("K1 backward (32768, 256) bf16", ce.backward_cost(32768, 256, 2, 4), F32_PEAK, 0.0101,
     "bytes"),
    ("K2 forward (8, 1024, 12, 64) causal", fa.forward_cost(8, 12, 1024, 64, True, 2),
     PEAK_FLOPS, 0.0151, "bytes"),
    ("K2 backward (8, 1024, 12, 64) causal", fa.backward_cost(8, 12, 1024, 64, True, 2),
     PEAK_FLOPS, 0.0326, "operations"),
    ("K2 forward (256, 197, 6, 64)", fa.forward_cost(256, 6, 197, 64, False, 2), PEAK_FLOPS,
     0.0466, "bytes"),
    ("K2 backward (256, 197, 6, 64)", fa.backward_cost(256, 6, 197, 64, False, 2), PEAK_FLOPS,
     0.0929, "bytes"),
    ("K2 forward (32, 1024, 12, 64) causal", fa.forward_cost(32, 12, 1024, 64, True, 2),
     PEAK_FLOPS, 0.0606, "bytes"),
    ("K2 backward (32, 1024, 12, 64) causal", fa.backward_cost(32, 12, 1024, 64, True, 2),
     PEAK_FLOPS, 0.1304, "operations"),
    ("K3 (8, 1, 12, 640, 64) pos 639", da.cost(12, 64, 1, 8 * 640, 8 * 12 * 64 * 2),
     F32_PEAK, 0.0025, "bytes"),
]


@pytest.mark.parametrize("row", BOUNDS, ids=[r[0] for r in BOUNDS])
def test_the_shared_formulas_give_perf_md_s_bounds(row):
    _, cost, peak, expected, by = row
    ms, bound_by = roofline.bound_ms(*cost, roofline.PEAK_HBM_BYTES[H100], peak)
    assert (round(ms, 4), bound_by) == (expected, by)


def test_k4_s_33_calls_give_perf_md_s_bound():
    assert round(_k4_step_bound(), 4) == 3.6630
