"""On the card: a tiny cell's traced run reads every per-layer metric of
its family from the profiler, with the card busy and each share in range.
Run on the chip with `python3 -m pytest portbench/tests -m cuda`."""

from __future__ import annotations

import time

import pytest

from portbench import manifest, run


@pytest.mark.cuda
@pytest.mark.parametrize("cell, expected", [
    ("tiny-gpt-train", {"mfu.lm", "optimizer_ms.lm", "elementwise_ms.lm", "k2_roofline.lm",
                        "device_idle.lm"}),
    ("tiny-resnet-train", {"mfu.resnet", "optimizer_ms.resnet", "batchnorm_ms.resnet",
                           "k4_roofline.resnet", "device_idle.resnet"}),
])
def test_a_traced_run_on_the_card_reads_every_per_layer_metric(bench_root, card, cell, expected):
    bench = manifest.load(bench_root)
    result, _ = run.run_cell(bench, bench.cell(cell), 2**31 + 5, 1.0, True, card,
                             start=time.monotonic())
    metrics = result["metrics"]
    assert set(metrics) == expected
    device = result["device"]
    assert 0 < device["busy_s"] <= device["window_s"]
    idle = next(m["value"] for name, m in metrics.items() if name.startswith("device_idle."))
    assert idle == pytest.approx(100.0 * (1.0 - device["busy_s"] / device["window_s"]))
    assert all(0 <= m["value"] <= 105 for name, m in metrics.items() if m["unit"] == "%")
    assert result["breakdown"]["device_ops"] and result["device"]["memory_peak_bytes"] > 0
