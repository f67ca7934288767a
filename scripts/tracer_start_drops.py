"""How many of a trace's first launches lose their device records.

Runs ``chip_smoke.py`` up to the end of its last serving model's phase 4
(qwen3-moe), with ``device_busy`` wrapped: each profiled call is first
traced once more opened by one small launch and no primer (as
``device_busy`` was before ``TRACER_PRIMER``), then by ``device_busy``
itself.  For each unprimed trace it reports the launches the call made
(host records), the kernels matched to them and the positions of the
launches whose kernel record is missing; beside it, the kernels
``device_busy`` counted.  Writes ``chiprun_out/tracer_start_drops.json``
and prints one line a model.  On the card, from the repo's root::

    python3 scripts/tracer_start_drops.py
"""
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))
import chip_smoke as cs  # noqa: E402

LAST = "qwen3"
LOG = []
primed_busy = cs.device_busy


def unprimed(fn) -> dict:
    from torch.profiler import ProfilerActivity, profile, record_function
    marker = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.ones(1, device="cuda").sum()
        torch.cuda.synchronize()
        with record_function("traced_fn"):
            marker.fill_(1.0)
            fn()
            torch.cuda.synchronize()
    out = os.path.join(ROOT, "build", "repro_torch", "start_drops.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    prof.export_chrome_trace(out)
    with open(out) as f:
        events = json.load(f).get("traceEvents", [])
    mark = next(e for e in events if e.get("name") == "traced_fn"
                and e.get("cat") == "user_annotation")
    lo, hi = mark["ts"], mark["ts"] + mark["dur"]
    launches = sorted((e for e in events
                       if str(e.get("cat", "")).startswith("cuda_")
                       and lo <= e["ts"] <= hi and "aunch" in e["name"]),
                      key=lambda e: e["ts"])
    traced = {e.get("args", {}).get("correlation") for e in events
              if e.get("cat") == "kernel"}
    # position 0 is the marker's fill
    lost = [i for i, e in enumerate(launches)
            if e["args"].get("correlation") not in traced]
    ids = {e["args"].get("correlation") for e in launches[1:]}
    return dict(host_launches=len(launches) - 1,
                graph=any(e["name"] == "cudaGraphLaunch" for e in launches),
                kernels_matched=sum(
                    1 for e in events if e.get("cat") == "kernel"
                    and e.get("args", {}).get("correlation") in ids),
                lost_positions=lost)


def wrapped(fn, names=()):
    rec = unprimed(fn)
    res = primed_busy(fn, names)
    rec["primed_kernels"] = res["kernels"]
    LOG.append(rec)
    return res


def main() -> int:
    results = {}
    real_serving = cs.phase_serving

    def serving(cfg, gen, pdt=None):
        LOG.clear()
        try:
            return real_serving(cfg, gen, pdt)
        finally:
            results[cfg.name] = list(LOG)
            print(cfg.name, json.dumps(LOG), flush=True)
            out = os.path.join(ROOT, "chiprun_out", "tracer_start_drops.json")
            os.makedirs(os.path.dirname(out), exist_ok=True)
            with open(out, "w") as f:
                json.dump(dict(card=cs.card_line(), models=results), f,
                          indent=1)
            if cfg.name.startswith(LAST):
                os._exit(0)

    cs.device_busy = wrapped
    cs.phase_serving = serving
    return cs.main()


if __name__ == "__main__":
    sys.exit(main())
