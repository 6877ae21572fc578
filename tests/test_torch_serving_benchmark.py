"""The port's benchmark tools on the CPU at a tiny size.

``paddle_tpu_torch.tools.serving_benchmark`` must write the report the
reference tool writes (the same keys where they mean the same thing),
with status accounting that adds up, and drive the same traffic: for the
same arguments its workload section and every request's prompt and
output token counts equal those of ``tools/serving_benchmark.py``, run in
a subprocess on the JAX CPU backend (no EOS is passed, so every finished
request gives exactly its ``max_new`` tokens). A resilience row (a queue
bound, a tiny pool, a fault schedule) must account for every arrival.
``paddle_tpu_torch.tools.train_benchmark`` must train the tiny row with
finite losses and report its methods side by side.
"""
import json
import os
import subprocess
import sys

import pytest

from paddle_tpu_torch.tools import serving_benchmark, train_benchmark

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["--preset", "tiny", "--requests", "8"]
TERMINAL = ("finished", "expired", "shed", "failed")


def _port(tmp_path, extra=()):
    out = tmp_path / "port.json"
    assert serving_benchmark.main(ARGS + list(extra) + [
        "--device", "cpu", "--out", str(out)]) == 0
    return json.loads(out.read_text())


def _accounting(report):
    rows = report["requests_detail"]
    assert all(r["status"] in TERMINAL for r in rows)
    by = report["requests_by_status"]
    assert sum(by.values()) == len(rows)
    rejected = sum(report["rejected_at_admission"].values())
    assert len(rows) + rejected == report["workload"]["requests"]
    assert by.get("finished", 0) == report["requests_finished"]
    assert report["goodput_tok_s"] <= report["value"]
    shed = report["shed_by_reason"]
    assert report["requests_shed_total"] == sum(shed.values())
    assert shed.get("queue_full", 0) == report["rejected_at_admission"].get(
        "queue_full", 0)
    assert by.get("expired", 0) == shed.get("expired", 0)
    assert by.get("failed", 0) == shed.get("poison", 0)
    assert by.get("shed", 0) == shed.get("preempt_cap", 0)


def test_report_matches_reference_tool(tmp_path):
    ref_out = tmp_path / "ref.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "serving_benchmark.py")]
        + ARGS + ["--no-trace", "--out", str(ref_out)],
        cwd=tmp_path, env=env, check=True, timeout=240,
        stdout=subprocess.DEVNULL)
    want = json.loads(ref_out.read_text())
    got = _port(tmp_path)
    assert got["workload"] == want["workload"]
    assert [(r["prompt_tokens"], r["output_tokens"], r["status"])
            for r in got["requests_detail"]] == [
        (r["prompt_tokens"], r["output_tokens"], r["status"])
        for r in want["requests_detail"]]
    # the reference's keys, less its compile counters (eager PyTorch
    # compiles nothing), its backend name and its warm-up compile time
    dropped = {"decode_compiles", "prefill_compiles", "backend",
               "warmup_compile_s"}
    assert set(want) - dropped <= set(got)
    assert set(want["quant"]) == set(got["quant"])
    assert set(want["requests_detail"][0]) - {"weights_generation"} \
        <= set(got["requests_detail"][0])
    assert got["device"] == "cpu" and got["device_name"] is None
    assert got["output_tokens"] == sum(
        r["output_tokens"] for r in got["requests_detail"]) > 0
    assert got["shed_by_reason"] == {} and got["requests_finished"] == 8
    _accounting(got)
    # the output hash is the reference's function of the token ids
    assert serving_benchmark.token_hash([]) == "cbf29ce484222325"
    assert all(len(r["output_token_hash"]) == 16
               for r in got["requests_detail"])


@pytest.mark.parametrize("flags", [
    ["--prefix-cache", "--chunked-prefill", "--shared-prefix-tokens", "16",
     "--prefix-groups", "2"],
    ["--quant-weights", "--quant-kv"]], ids=["prefix-chunked", "quant"])
def test_tier2_rows(tmp_path, flags):
    got = _port(tmp_path, flags + ["--rate", "100"])
    _accounting(got)
    assert got["requests_finished"] == 8
    w = got["workload"]
    if "--prefix-cache" in flags:
        assert w["prefix_cache"] and w["chunked_prefill"]
        assert got["prefix_cache_hit_tokens_total"] > 0
        assert got["prefill_chunks"] > 0
    else:
        assert w["quant_weights"] and w["quant_kv"]
        assert got["quant"]["kv_capacity_headroom_vs_fp32"] > 1.8
        assert got["quant"]["kv_quant_pages"] >= 0


def test_resilience_row_accounts_for_every_arrival(tmp_path):
    got = _port(tmp_path, [
        "--rate", "1000", "--num-blocks", "8", "--max-queue", "3",
        "--deadline-s", "30", "--fault-schedule",
        "serving.prefill:error@3;serving.decode:error@5"])
    _accounting(got)
    assert got["faults_injected"] == {"serving.prefill:error@3": 1,
                                      "serving.decode:error@5": 1}
    assert got["shed_by_reason"].get("poison", 0) >= 1


def test_train_benchmark_tiny():
    report = train_benchmark.run(preset="tiny", fuse=True, device="cpu",
                                 k=2, windows=1, batch=2, seq=32)
    assert report["steps"] == 2 * 2 + 2
    losses = report["run_steps"]["window_losses"] + report["calls"]["losses"]
    assert all(x == x and abs(x) < 1e3 for x in losses)
    # each window trains on the same batches again: its last loss falls
    assert report["run_steps"]["window_losses"][1] \
        < report["run_steps"]["window_losses"][0]
    assert report["first_loss"] == report["calls"]["losses"][0]
    assert report["window_vs_calls_loss_gap"] < 1e-4
    assert report["device_name"] is None and report["params"] > 0
    for method in ("run_steps", "calls"):
        assert report[method]["step_ms"] > 0
        assert report[method]["tokens_per_s"] > 0
