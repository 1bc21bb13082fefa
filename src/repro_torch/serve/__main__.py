"""Continuous-batching serving driver of the port — the twin of the
reference's ``examples/serve_lm.py``, with the same flags and defaults
(smoke config) plus ``--device``.

Requests arrive at an offered load, queue for slots, and every scheduler
step is priced by the SoC latency oracle, so throughput and tail latency
come out in *simulated SoC seconds*; the model runs on ``--device``
(``cuda`` unless asked otherwise, through the port's Hopper kernels).

Run:  PYTHONPATH=src python -m repro_torch.serve [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import ARCHS, get_smoke_config
from repro_torch.models import init_params
from repro_torch.serve import Request, ServeEngine
from repro_torch.types import param_values
from repro_torch.utils.env import default_device


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.serve")
    ap.add_argument("--arch", choices=ARCHS, default="mamba2-130m")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--gap-us", type=float, default=100.0,
                    help="arrival gap between requests (simulated µs)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)

    dev = default_device(args.device)
    cfg = get_smoke_config(args.arch)
    params = param_values(init_params(0, cfg, device=dev))
    eng = ServeEngine(cfg, params,
                      cache_len=args.prompt_len + args.max_new + 8,
                      max_slots=args.max_slots, eos_id=0,
                      temperature=args.temperature, device=dev)

    rng = np.random.default_rng(1)
    for i in range(args.requests):
        eng.submit(Request(
            rid=i,
            tokens=tuple(int(t) for t in
                         rng.integers(3, cfg.vocab_size, args.prompt_len)),
            max_new=args.max_new, arrival_s=i * args.gap_us * 1e-6))

    t0 = time.perf_counter()
    stats = eng.run()
    dt = time.perf_counter() - t0
    print(f"arch={cfg.name}  device={dev}  requests={args.requests}  "
          f"slots={args.max_slots}  prompt={args.prompt_len}")
    print(f"host: {stats.tokens} tokens in {dt:.2f}s wall "
          f"(model {eng.wall_s['model']:.2f}s, oracle "
          f"{eng.wall_s['oracle']:.2f}s)")
    print(f"simulated SoC: {stats.tokens_per_s:.0f} tok/s over "
          f"{stats.sim_time_s * 1e3:.3f} ms "
          f"(p50 {stats.latency_p50_s * 1e3:.3f} ms, "
          f"p99 {stats.latency_p99_s * 1e3:.3f} ms)")
    print(f"steps: {stats.prefill_steps} prefill / {stats.decode_steps} "
          f"decode / {stats.idle_steps} idle; "
          f"occupancy mean {stats.mean_occupancy:.2f} "
          f"max {stats.max_occupancy}")
    decode_hits = [r.llc_hit_rate for r in eng.step_log
                   if r.kind == "decode" and r.llc_hit_rate is not None]
    if decode_hits:
        print(f"decode LLC hit rate: min {min(decode_hits):.3f} "
              f"max {max(decode_hits):.3f}")
    sample = eng.finished[0]
    print(f"sample rid={sample['rid']}: {sample['tokens'][:10]} "
          f"(latency {sample['latency_s'] * 1e3:.3f} ms)")


if __name__ == "__main__":
    main()
