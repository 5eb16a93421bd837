"""Serve a small model with batched requests through the elastic batcher.

    python -m repro_torch.examples.serve_lm [--device cpu]

Twin of the reference's ``examples/serve_lm.py``: heavy-tailed request
lengths, continuous batching over the port's real decode engine, and the
occupancy controller retuning prefill-chunk size and decode-burst length
live, static and adaptive in turn.  Every request must be answered.
"""
from __future__ import annotations

import argparse

from ..device import DeviceLike, resolve_device
from ..launch.serve import serve

__all__ = ["main"]


def main(device: DeviceLike = None, *, n_requests: int = 24,
         n_slots: int = 4, max_seq: int = 128) -> dict:
    device = resolve_device(device)
    out = {}
    for adaptive in (False, True):
        rep = serve("gemma3-1b", smoke=True, n_requests=n_requests,
                    n_slots=n_slots, max_seq=max_seq, adaptive=adaptive,
                    device=device)
        assert rep["requests"] == n_requests, "every request is answered"
        mode = "adaptive (§5.2 controller)" if adaptive else "static"
        print(f"{mode:28s} requests={rep['requests']} "
              f"rounds={rep['rounds']} tok/s={rep['tok_per_s']:.1f} "
              f"ttft_p50={rep['ttft_p50']*1e3:.0f}ms "
              f"ttft_p99={rep['ttft_p99']*1e3:.0f}ms")
        out["adaptive" if adaptive else "static"] = rep
    print("request-duration characterization (paper §4.2 lens):")
    print(" ", rep["characterization"])
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None)
    main(ap.parse_args().device)
