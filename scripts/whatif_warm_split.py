#!/usr/bin/env python3
"""Where does a warm what-if answer's time go: the planner, a thread, HTTP?

    python3 scripts/whatif_warm_split.py [--rounds 3]

``chip_smoke.py``'s ``whatif`` phase times a cold pass in the main thread
and a warm pass over HTTP (a handler thread of ``make_server``).  This
script answers the phase's queries (its fleet of three 1,000-job queues
and ``fig_whatif.py``'s query set, taken from ``chip_smoke.py``) with one
planner on cuda, per family: once cold after ``reset_cache_stats(clear=
True)``, then ``--rounds`` rounds of three warm passes in a rotating
order: ``main`` (``planner.answer`` in this thread), ``thread`` (the same
call in a new thread, joined) and ``http`` (a POST to a server whose
planner is this one, served from a thread of this process).  Every pass
does the same work (the baselines are cached by the cold pass), so the
differences are the thread and the HTTP round trip.  Prints one JSON line
a family: the seconds a query of each pass.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import sys
import threading
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    rounds = ap.parse_args(argv).rounds
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("whatif_warm_split: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    import repro_torch as rt
    from repro_torch import service
    from repro_torch.kernels import _build
    _build.build_all()
    print(chip_smoke.nvidia_smi(), flush=True)
    for family, queries in chip_smoke.whatif_queries(service).items():
        rt.reset_cache_stats(clear=True)
        planner = service.CapacityPlanner(chip_smoke.whatif_fleet(rt),
                                          device="cuda")
        server = service.make_server(planner.fleet, device="cuda")
        server.planner = planner
        serving = threading.Thread(target=server.serve_forever, daemon=True)
        serving.start()

        def main_pass():
            for q in queries:
                planner.answer(q)

        def thread_pass():
            worker = threading.Thread(target=main_pass)
            worker.start()
            worker.join()

        def http_pass():
            for q in queries:
                status, body = chip_smoke.http_json(f"{server.url}/query",
                                                    q.to_json_dict())
                if status != 200:
                    raise SystemExit(f"whatif_warm_split: {status}: {body}")

        passes = {"main": main_pass, "thread": thread_pass,
                  "http": http_pass}
        times = {k: [] for k in passes}
        try:
            t = time.time()
            main_pass()
            cold = (time.time() - t) / len(queries)
            names = list(passes)
            for r in range(rounds):
                for name in names[r % 3:] + names[:r % 3]:
                    t = time.time()
                    passes[name]()
                    times[name].append((time.time() - t) / len(queries))
        finally:
            server.shutdown()
            server.server_close()
            serving.join()
        print(json.dumps({
            "family": family, "queries": len(queries),
            "cold_s_per_query": cold,
            "warm_s_per_query": times,
            "median_over_cold": {k: statistics.median(v) / cold
                                 for k, v in times.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
