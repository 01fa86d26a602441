"""Stdlib HTTP front end for the port's capacity planner (DESIGN.md §20).

Counterpart of ``repro.service.http``, with the same routes, statuses and
error bodies.  No framework, no new dependencies: a ``ThreadingHTTPServer``
wrapping one :class:`~repro_torch.service.planner.CapacityPlanner`, which
serializes query evaluation internally (HTTP concurrency buys request
pipelining, not parallel sweeps); its handler threads run the planner's
sweeps on its device.  Routes:

- ``GET  /health``  — liveness + queue names;
- ``GET  /fleet``   — per-queue baseline metrics (fleet-status aggregation);
- ``GET  /cache``   — sweep executable-cache counters;
- ``POST /query``   — one :class:`WhatIfQuery` JSON document in, one
  recommendation response out.

Errors are structured: ``{"error": {"type": ..., "message": ...}}`` with
400 for malformed/invalid documents, 404 for unknown queues, 422 for
schema-valid but unanswerable queries (e.g. reliability against a queue
with no failure model), 404 for bad routes, and 500 for a failure while
answering (on the card too).

``python -m repro_torch.service --fleet fleet.json`` serves a fleet
config; ``--demo`` serves a small built-in three-queue fleet.  The planner
runs on ``cuda`` unless ``--device`` names another device, and exits with
an error where there is no card.
"""

from __future__ import annotations

import argparse
import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple

from repro_torch.api import FailureModel, Scenario, SyntheticTrace, Topology

from repro_torch.service.planner import CapacityPlanner, UnknownQueueError
from repro_torch.service.query import (
    SchemaError, WhatIfQuery, canonical_dumps, fleet_from_json,
)

# SchemaError.code -> HTTP status: a query that *cannot be expressed* is the
# client's fault (400); one that is well-formed but unanswerable here is 422
_STATUS_BY_CODE = {"unknown_field": 400, "missing_field": 400,
                   "bad_value": 400, "bad_version": 400, "unsupported": 422}


def demo_fleet() -> Dict[str, Scenario]:
    """Small three-queue fleet: a scalar-counter batch queue, a mesh2d
    queue with contiguous allocation, and a failure-prone backfill queue —
    one of each mode so every query kind has a natural target."""
    return {
        "batch": Scenario(
            trace=SyntheticTrace(n_jobs=200, seed=0, kind="sdsc_sp2"),
            total_nodes=128, policy="fcfs"),
        "mesh": Scenario(
            trace=SyntheticTrace(n_jobs=200, seed=1, kind="sdsc_sp2"),
            topology=Topology.mesh2d(8, 16), policy="sjf",
            alloc="contiguous"),
        "flaky": Scenario(
            trace=SyntheticTrace(n_jobs=200, seed=2, kind="sdsc_sp2"),
            total_nodes=128, policy="backfill",
            failures=FailureModel(mtbf=1_000_000.0, seed=7,
                                  max_failures=512)),
    }


class _Handler(BaseHTTPRequestHandler):
    server: "WhatIfServer"
    protocol_version = "HTTP/1.1"

    # -- plumbing ------------------------------------------------------------

    def _send(self, status: int, payload: Dict[str, Any]) -> None:
        body = canonical_dumps(payload).encode("utf-8")
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _error(self, status: int, err_type: str, message: str) -> None:
        self._send(status, {"error": {"type": err_type, "message": message}})

    def log_message(self, fmt, *args):  # quiet by default
        if self.server.verbose:
            super().log_message(fmt, *args)

    # -- routes --------------------------------------------------------------

    def do_GET(self):
        planner = self.server.planner
        try:
            if self.path == "/health":
                self._send(200, {"status": "ok", "version": 1,
                                 "queues": sorted(planner.fleet)})
            elif self.path == "/fleet":
                self._send(200, planner.fleet_status())
            elif self.path == "/cache":
                self._send(200, planner.fleet_status()["cache"])
            else:
                self._error(404, "not_found",
                            f"no route {self.path!r}; routes: /health "
                            "/fleet /cache, POST /query")
        except Exception as e:  # noqa: BLE001 — a request must not kill the server
            self._error(500, "internal", f"{type(e).__name__}: {e}")

    def do_POST(self):
        if self.path != "/query":
            self._error(404, "not_found",
                        f"no POST route {self.path!r}; POST /query")
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(length).decode("utf-8")
            query = WhatIfQuery.from_json(body)
            self._send(200, self.server.planner.answer(query))
        except SchemaError as e:
            self._error(_STATUS_BY_CODE.get(e.code, 400), e.code, str(e))
        except UnknownQueueError as e:
            self._error(404, "unknown_queue", str(e))
        except Exception as e:  # noqa: BLE001
            self._error(500, "internal", f"{type(e).__name__}: {e}")


class WhatIfServer(ThreadingHTTPServer):
    """ThreadingHTTPServer + the planner it fronts (on ``device``,
    ``cuda`` by default)."""

    daemon_threads = True

    def __init__(self, fleet: Dict[str, Scenario],
                 address: Tuple[str, int] = ("127.0.0.1", 0), *,
                 verbose: bool = False, device=None):
        planner = CapacityPlanner(fleet, device=device)
        super().__init__(address, _Handler)
        self.planner = planner
        self.verbose = verbose

    @property
    def url(self) -> str:
        host, port = self.server_address[:2]
        return f"http://{host}:{port}"


def make_server(fleet: Dict[str, Scenario], host: str = "127.0.0.1",
                port: int = 0, *, verbose: bool = False,
                device=None) -> WhatIfServer:
    """Build (but don't start) a service; ``port=0`` picks a free port.
    ``device=None`` runs the planner on ``cuda``."""
    return WhatIfServer(fleet, (host, port), verbose=verbose, device=device)


def main(argv: Optional[list] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.service",
        description="What-if capacity-planning query service")
    src = parser.add_mutually_exclusive_group(required=True)
    src.add_argument("--fleet", help="fleet config JSON "
                     '({"version": 1, "queues": {name: scenario}})')
    src.add_argument("--demo", action="store_true",
                     help="serve the built-in three-queue demo fleet")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=0,
                        help="0 picks a free port (printed on startup)")
    parser.add_argument("--verbose", action="store_true",
                        help="log every request")
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    args = parser.parse_args(argv)

    if args.demo:
        fleet = demo_fleet()
    else:
        with open(args.fleet, "r", encoding="utf-8") as f:
            try:
                doc = json.load(f)
            except json.JSONDecodeError as e:
                parser.error(f"{args.fleet}: not valid JSON: {e}")
        fleet = fleet_from_json(doc)

    server = make_server(fleet, args.host, args.port, verbose=args.verbose,
                         device=args.device)
    # the subprocess smoke test scrapes this exact line for the bound port
    print(f"serving on {server.url}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
    return 0
