#!/usr/bin/env python3
"""Profile the ``flash_attention`` split-key decode path on one card.

    python3 scripts/profile_flash_decode.py

At decode_path's dense step shape (b = 4, h = 16, sq = 1, sk = 32,768,
dh = 128), in f32 and bf16: torch.profiler's table of CUDA time by kernel
(the split kernel and the combine) over 20 calls, then the CUDA-event time
of 20 calls issued back to back (ms a call), which hides the wrapper's
host time behind the device's.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("profile_flash_decode: no CUDA device is visible",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import ops
    for dt in (torch.float32, torch.bfloat16):
        g = torch.Generator("cuda").manual_seed(0)
        q, k, v = (torch.randn((4, 16, s, 128), generator=g,
                               device="cuda").to(dt)
                   for s in (1, 32768, 32768))
        for _ in range(3):
            ops.flash_attention(q, k, v)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                ops.flash_attention(q, k, v)
            torch.cuda.synchronize()
        print(dt)
        print(prof.key_averages().table(sort_by="cuda_time_total",
                                        row_limit=8,
                                        max_name_column_width=60))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(20):
            ops.flash_attention(q, k, v)
        end.record()
        end.synchronize()
        print("back-to-back ms/call", start.elapsed_time(end) / 20)
    return 0


if __name__ == "__main__":
    sys.exit(main())
