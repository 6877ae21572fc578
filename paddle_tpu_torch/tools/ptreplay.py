"""ptreplay: re-drive a recorded serving workload and check its tokens (the
port of tools/ptreplay.py).

    python3 -m paddle_tpu_torch.tools.ptreplay run JOURNAL
        [--out report.json] [--full] [--matrix] [--against JOURNAL2]
        [--device cuda|cpu]

The record half is ``serving/replay.py`` (``FLAGS_serving_replay``, or the
serving benchmark's ``--record-out``). This tool rebuilds the model from
the journal header's ``model`` meta, builds a fresh ``serving.Engine`` per
recorded engine with that engine's latched flags and capabilities,
re-drives every finished request (no deadline: the replaying host's speed
must not matter) and compares each output's rolling token hash with the
recording. Greedy decoding reads only a request's own pages, so the order
and batching of the replay cannot change a token. Exit code 2 on any
divergence, else 0.

  --full       per diverging request, the first diverging index and both
               token lists
  --matrix     replay under the recorded flags, then once per flag axis
               (prefix, chunked, quant_kv, quant_weights) with that one
               axis flipped; a baseline divergence names ``weights`` (the
               flags equal the recording's, so the re-execution itself
               disagrees) and skips the flips; else each diverging flip
               names its axis (for the quant axes that is lossy numerics,
               not a fault)
  --against J2 diff two recordings request by request (finished entries
               in admission order), rebuilding nothing

The engine runs on the card unless ``--device cpu`` (the tests' device).

Where the port differs from the reference's tool:

- **Compile checks.** The reference re-checks that replay reused its one
  compiled decode step (``decode_compiles``, ``compile_once_ok``, exit
  code 4). The port runs PyTorch eagerly and compiles no step, so none of
  these exist here.
- **Weights.** ``_build_model`` rebuilds the port's own initialisation:
  ``LlamaForCausalLM(LlamaConfig(**config), generator=torch.Generator(
  gen_device).manual_seed(seed))``, the serving benchmark's path, with
  ``gen_device`` the device the recording drew them on (the meta's
  ``weights``). A journal the JAX package recorded drew its weights from
  ``paddle.seed``, which the torch RNG cannot reproduce: rebuilding
  would replay other weights and report a false ``weights`` divergence,
  so ``_build_model`` raises for a journal whose meta does not name the
  port's initialisation. ``replay_entries`` and ``matrix_bisect`` take a
  ``model`` (a module on the replay device, or a factory called once per
  engine) instead, e.g. the JAX model's weights carried across by
  ``models.convert.load_jax_state``.
- **Counts.** Divergences count into ``serving.replay.divergences()`` by
  axis; the port has no incident plane.
- Not ported: ``smoke`` (the battery row and its committed snapshot).
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import time

import torch

# what the port's serving benchmark writes into a journal's model meta
# ("weights"): the initialisation that _build_model reproduces
PORT_INIT = "paddle_tpu_torch.LlamaForCausalLM"


def _first_divergence(a, b):
    """Index of the first differing token, or None if identical."""
    n = min(len(a), len(b))
    for i in range(n):
        if a[i] != b[i]:
            return i
    if len(a) != len(b):
        return n
    return None


def weights_meta(device):
    """The model meta's ``weights`` block for weights drawn by the port's
    initialisation on ``device``."""
    return {"init": PORT_INIT, "generator_device": torch.device(device).type}


def _build_model(model_meta, device):
    """The benchmark's model path: config kwargs and the init seed, drawn
    on the recorded generator device and moved to ``device``."""
    from ..models import LlamaConfig, LlamaForCausalLM

    if not model_meta or "config" not in model_meta:
        raise ValueError(
            "journal carries no model meta (record with serving_benchmark "
            "--record-out, or note_model() a {'config': {...}, 'seed': N, "
            "'weights': ...} block before write_journal)")
    weights = model_meta.get("weights") or {}
    if weights.get("init") != PORT_INIT:
        raise ValueError(
            "journal's weights were not drawn by the port's initialisation "
            "(model meta 'weights' = %r): a JAX recording seeds paddle.seed, "
            "which the torch RNG cannot reproduce, so rebuilding would "
            "replay other weights and report a false 'weights' divergence; "
            "pass the model to replay_entries(model=...) instead (its "
            "weights carried across with models.convert.load_jax_state)"
            % (weights or None,))
    gen_device = torch.device(weights.get("generator_device", "cuda"))
    cfg = LlamaConfig(**model_meta["config"])
    model = LlamaForCausalLM(
        cfg, device=gen_device, generator=torch.Generator(
            device=gen_device).manual_seed(int(model_meta.get("seed", 0))))
    return model.to(device)


def _perturb_one_leaf(model, scale=1.5):
    """Scale the first 2-D weight in place: the deliberate divergence that
    shows the check can fail a changed model. Returns its name."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() == 2:
                p.mul_(scale)
                return name
    raise RuntimeError("no 2-D weight leaf to perturb")


def _model_for(head, model, device, perturb):
    """The model one recorded engine replays on: rebuilt from the meta, or
    the caller's (``model`` a module, or a factory called here); a
    caller's module is copied before a perturbation."""
    if model is None:
        m = _build_model(head.get("model"), device)
    elif isinstance(model, torch.nn.Module):
        m = copy.deepcopy(model) if perturb else model
    else:
        m = model()
    leaf = _perturb_one_leaf(m) if perturb else None
    return m, leaf


def replay_entries(head, entries, flags_override=None, full=False,
                   perturb=False, model=None, device="cuda"):
    """Re-drive every finished entry through a fresh engine for each
    recorded engine id (the recorded flags, or ``flags_override`` over
    them, latched at its construction) and return the divergence block."""
    from ..core import flags as ptflags
    from ..serving import Engine
    from ..serving.replay import token_hash

    device = torch.device(device)
    replayable = [e for e in entries if e.get("state") == "finished"]
    skipped = {}
    for e in entries:
        if e.get("state") != "finished":
            skipped[e.get("state")] = skipped.get(e.get("state"), 0) + 1
    by_engine = {}
    for e in replayable:
        by_engine.setdefault(str(e.get("engine", 0)), []).append(e)

    divergences = []
    perturbed_leaf = None
    for eid, group in sorted(by_engine.items()):
        snap = (head.get("engines") or {}).get(eid) or {}
        latched = dict(snap.get("flags") or group[0]["flags"])
        if flags_override:
            latched.update(flags_override)
        # the replay must not record itself
        latched["FLAGS_serving_replay"] = False
        caps = snap.get("caps") or {}
        m, perturbed_leaf = _model_for(head, model, device, perturb)
        before = ptflags.get_flags(list(latched))
        ptflags.set_flags(latched)      # latched at construction
        try:
            eng = Engine(
                m, max_slots=int(caps.get("max_slots", 4)),
                num_blocks=int(caps.get("num_blocks", 128)),
                block_size=int(caps.get("block_size", 16)),
                prefill_chunk=int(caps.get("prefill_chunk", 16)),
                max_model_len=caps.get("max_model_len"), device=device)
        finally:
            ptflags.set_flags(before)
        rid_of = {}
        for e in group:
            rid = eng.add_request(e["prompt"],
                                  max_new_tokens=e["max_new_tokens"],
                                  eos_token_id=e.get("eos_token_id"))
            rid_of[rid] = e
        eng.run()
        for rid, e in rid_of.items():
            got = eng.output(rid)
            got_hash = token_hash(got)
            want_hash = (e.get("output_token_hash")
                         or token_hash(e.get("output") or ()))
            if got_hash == want_hash:
                continue
            row = {"id": e["id"], "trace_id": e.get("trace_id"),
                   "engine": eid, "recorded_hash": want_hash,
                   "replayed_hash": got_hash,
                   "weights_generation": e.get("weights_generation"),
                   "first_divergence": _first_divergence(
                       e.get("output") or [], got)}
            if full:
                row["recorded_tokens"] = e.get("output")
                row["replayed_tokens"] = got
            divergences.append(row)
        del eng, m
    return {
        "replayed": len(replayable),
        "skipped": skipped,
        "divergence_count": len(divergences),
        "divergences": divergences,
        "perturbed_leaf": perturbed_leaf,
    }


def matrix_bisect(head, entries, full=False, perturb=False, model=None,
                  device="cuda"):
    """Replay under the recorded flags, then once per flag axis with that
    axis flipped. A baseline divergence names ``weights`` and skips the
    flips (each would inherit the same difference); a clean baseline
    names each axis whose flip diverges."""
    from ..serving.replay import FLAG_AXES

    kw = dict(full=full, perturb=perturb, model=model, device=device)
    baseline = replay_entries(head, entries, **kw)
    if baseline["divergence_count"]:
        return {"baseline_divergences": baseline["divergence_count"],
                "baseline": baseline, "axes": {},
                "bisected_axes": ["weights"]}
    recorded = {}
    for snap in (head.get("engines") or {}).values():
        recorded.update(snap.get("flags") or {})
    axes = {}
    for axis, flag in FLAG_AXES:
        flipped = not bool(recorded.get(flag))
        res = replay_entries(head, entries, flags_override={flag: flipped},
                             **kw)
        axes[axis] = {"flag": flag, "flipped_to": flipped,
                      "divergences": res["divergence_count"]}
    return {"baseline_divergences": 0, "baseline": baseline, "axes": axes,
            "bisected_axes": [a for a, r in axes.items()
                              if r["divergences"]]}


def diff_journals(head_a, entries_a, head_b, entries_b, full=False):
    """Pairwise token diff of two recordings (``--against``): finished
    entries matched in admission order; a pair whose prompts or lengths
    differ counts as a workload mismatch, not a divergence."""
    fin_a = [e for e in entries_a if e.get("state") == "finished"]
    fin_b = [e for e in entries_b if e.get("state") == "finished"]
    pairs = min(len(fin_a), len(fin_b))
    divergences = []
    mismatches = 0
    for i in range(pairs):
        a, b = fin_a[i], fin_b[i]
        if a["prompt"] != b["prompt"] \
                or a["max_new_tokens"] != b["max_new_tokens"]:
            mismatches += 1
            continue
        if a.get("output_token_hash") == b.get("output_token_hash"):
            continue
        row = {"index": i, "id_a": a["id"], "id_b": b["id"],
               "hash_a": a.get("output_token_hash"),
               "hash_b": b.get("output_token_hash"),
               "weights_generation_a": a.get("weights_generation"),
               "weights_generation_b": b.get("weights_generation"),
               "first_divergence": _first_divergence(
                   a.get("output") or [], b.get("output") or [])}
        if full:
            row["tokens_a"] = a.get("output")
            row["tokens_b"] = b.get("output")
        divergences.append(row)
    return {"pairs": pairs, "unpaired": abs(len(fin_a) - len(fin_b)),
            "workload_mismatches": mismatches,
            "divergence_count": len(divergences),
            "divergences": divergences}


def _note_divergences(report):
    """Count the report's verdict by axis (``serving.replay``)."""
    from ..serving import replay

    matrix = report.get("matrix")
    if matrix and matrix["bisected_axes"]:
        for axis in matrix["bisected_axes"]:
            n = (matrix["baseline_divergences"] if axis == "weights"
                 else matrix["axes"][axis]["divergences"])
            replay.note_divergence(axis, max(n, 1))
    elif report.get("divergence_count"):
        replay.note_divergence("unknown", report["divergence_count"])


def _write_report(path, report):
    d = os.path.dirname(os.path.abspath(path))
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(report, f, indent=1, default=str)
        f.write("\n")
    os.replace(tmp, path)


def run_replay(args, model=None):
    """``ptreplay run``: load, replay (or diff, or bisect), write the
    report to ``args.out`` (when set) and return the exit code: 2 on a
    divergence, else 0. ``model`` as in ``replay_entries``."""
    from ..serving import replay

    device = getattr(args, "device", "cuda")
    head, entries = replay.load_journal(args.journal)
    report = {"kind": "replay_report", "version": 1,
              "journal": args.journal, "device": str(device),
              "measured_at": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                           time.gmtime()),
              "recorded": head.get("requests")}
    if args.against:
        head_b, entries_b = replay.load_journal(args.against)
        report["against"] = args.against
        report.update(diff_journals(head, entries, head_b, entries_b,
                                    full=args.full))
    elif args.matrix:
        m = matrix_bisect(head, entries, full=args.full, model=model,
                          device=device)
        report["matrix"] = m
        report["divergence_count"] = m["baseline_divergences"]
        report["divergences"] = m["baseline"]["divergences"]
    else:
        report.update(replay_entries(head, entries, full=args.full,
                                     model=model, device=device))
    if args.out:
        _write_report(args.out, report)
    _note_divergences(report)
    print(json.dumps({k: v for k, v in report.items()
                      if k not in ("divergences", "matrix")}), flush=True)
    if args.out:
        print("wrote", args.out, flush=True)
    if report.get("divergence_count"):
        axes = (report.get("matrix") or {}).get("bisected_axes")
        sys.stderr.write("DIVERGED: %d request(s)%s\n" % (
            report["divergence_count"],
            " (axes: %s)" % ",".join(axes) if axes else ""))
        return 2
    return 0


def parser():
    ap = argparse.ArgumentParser(
        description="deterministic serving record/replay audit")
    sub = ap.add_subparsers(dest="cmd", required=True)
    runp = sub.add_parser("run", help="replay a journal and diff")
    runp.add_argument("journal")
    runp.add_argument("--out", default="replay_report.json")
    runp.add_argument("--full", action="store_true",
                      help="token-level diff (first diverging index and "
                           "the token lists), not just digests")
    runp.add_argument("--matrix", action="store_true",
                      help="replay across the flag matrix and bisect the "
                           "diverging axis")
    runp.add_argument("--against", default=None,
                      help="diff against a second journal instead of "
                           "re-executing")
    runp.add_argument("--device", default="cuda",
                      help="cuda (the card) or cpu (the plain path)")
    return ap


def main(argv=None):
    return run_replay(parser().parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
