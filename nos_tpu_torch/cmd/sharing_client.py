"""The sharing-benchmark client on the card (port of
``demos/tpu-sharing-comparison/client/main.py``): continuous YOLOS-small
inference, exporting per-request latency so Prometheus can average it
over the pods that share one accelerator.

Sharing modes (``--mode``, default ``TPU_SHARING_MODE``):

- ``multiplex``: the N outstanding requests are coalesced into one
  batched bf16 forward per step (N images, one pass);
- ``timeslice``: requests run one at a time, so each stream sees the
  round trip of everyone ahead of it (one image a forward, the time
  times N);
- ``subslice``: the pod owns an isolated partition; its latency is the
  single-stream latency whatever N is (one stream).

Each forward is timed alone: on the card with CUDA events behind a
sync, on the CPU with the host clock; a window's latency is the median
of its forwards. The reference times a chain of jitted forwards to
cancel dispatch latency instead: an eager forward's own launches are
part of what a request waits for here.

Serves the histogram ``tpu_sharing_inference_seconds`` (labels mode,
streams) on ``--port``. With ``--oneshot`` it prints one JSON line,
``{"mode", "streams", "avg_inference_s"}``, and exits. It runs on the
card unless given ``--device cpu``.

    python -m nos_tpu_torch.cmd.sharing_client --mode multiplex \\
        --streams 7 --seconds 2 --oneshot
"""
from __future__ import annotations

import argparse
import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, HTTPServer
from typing import Optional, Sequence

import torch

from nos_tpu_torch.device import DeviceLike, resolve_device
from nos_tpu_torch.models import yolos
from nos_tpu_torch.utils.metrics import Histogram, Registry

MODES = ("multiplex", "timeslice", "subslice")

REGISTRY = Registry()
LATENCY = Histogram(
    "tpu_sharing_inference_seconds",
    "Per-request inference latency under TPU sharing",
    labelnames=("mode", "streams"),
    buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0),
)
REGISTRY.register(LATENCY)


class BenchRig:
    """The model and its images, built once and reused across windows:
    YOLOS at ``cfg`` (YOLOS-small by default) on seeded weights, and
    ``streams`` seeded images under ``multiplex`` (else one), on
    ``device`` (the card by default)."""

    def __init__(self, mode: str, streams: int,
                 cfg: Optional[yolos.YolosConfig] = None,
                 device: DeviceLike = None):
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        self.mode = mode
        self.streams = streams
        self.cfg = cfg if cfg is not None else yolos.YolosConfig()
        self.device = resolve_device(device)
        self.params = yolos.init_params(
            torch.Generator(self.device).manual_seed(0), self.cfg,
            self.device)
        batch = streams if mode == "multiplex" else 1
        size = self.cfg.image_size
        self.images = torch.randn(
            (batch, size, size, 3), dtype=torch.float32, device=self.device,
            generator=torch.Generator(self.device).manual_seed(1))
        self.forward_s()            # the first call builds the kernels

    @torch.no_grad()
    def forward_s(self) -> float:
        """Seconds of one batched forward, timed alone."""
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(self.device)
            start.record()
            yolos.forward(self.params, self.cfg, self.images)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3
        t0 = time.perf_counter()
        yolos.forward(self.params, self.cfg, self.images)
        return time.perf_counter() - t0

    def measure(self, seconds: float) -> float:
        """Median per-request latency for ``streams`` concurrent tenants
        over a window of ``seconds`` (at least 3 forwards)."""
        samples = []
        deadline = time.monotonic() + seconds
        while time.monotonic() < deadline or len(samples) < 3:
            per_step = self.forward_s()
            if self.mode == "timeslice":
                # each of the N streams waits for the N-1 ahead of it
                per_step *= self.streams
            samples.append(per_step)
        samples.sort()
        return samples[len(samples) // 2]


def serve_metrics(port: int) -> HTTPServer:
    """``REGISTRY``'s text exposition on ``port`` from a daemon thread;
    returns the server (``shutdown()`` stops it)."""
    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            body = REGISTRY.expose().encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    srv = HTTPServer(("", port), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def main(argv: Optional[Sequence[str]] = None,
         cfg: Optional[yolos.YolosConfig] = None) -> None:
    """The binary (the reference client's flags, and ``--device``);
    ``cfg`` sets the model for a caller that wants other widths."""
    ap = argparse.ArgumentParser(prog="nos-tpu-torch-sharing-client",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode",
                    default=os.environ.get("TPU_SHARING_MODE", "multiplex"),
                    choices=MODES)
    ap.add_argument("--streams", type=int,
                    default=int(os.environ.get("TPU_SHARING_STREAMS", "1")))
    ap.add_argument("--seconds", type=float, default=20.0,
                    help="measurement window per sample batch")
    ap.add_argument("--oneshot", action="store_true",
                    help="print one JSON result line and exit")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "plain PyTorch versions)")
    args = ap.parse_args(argv)

    # subslice pods each own an isolated partition: their latency is the
    # single-stream latency regardless of co-resident pod count
    streams = 1 if args.mode == "subslice" else args.streams
    rig = BenchRig(args.mode, streams, cfg=cfg, device=args.device)

    if args.oneshot:
        lat = rig.measure(args.seconds)
        print(json.dumps({
            "mode": args.mode, "streams": args.streams,
            "avg_inference_s": round(lat, 6),
        }), flush=True)
        return

    serve_metrics(args.port)
    h = LATENCY.labels(args.mode, str(args.streams))
    while True:
        h.observe(rig.measure(args.seconds))


if __name__ == "__main__":
    main()
