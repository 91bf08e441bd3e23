#!/usr/bin/env python3
"""Device time of the tensor-core paged decode kernels against the chunk a
block takes, at two page tables.

    PYTHONPATH=src python3 -m repro_torch.examples.paged_chunk_sweep

Needs a CUDA card. Paged GQA (B 8, Hkv 8, G 4, dh 128) and paged MLA (B 8,
H 128, R 576, kv_lora 512), bf16, pages of 16, at PERF.md §6's table (256
pages, pos [4095, 0, 15, 16, 323, 3951, 2897, 3934]) and at serving's
~1k-context table (128 pages, pos 1000–1050), for each chunk of
``CHUNKS`` (as the kernel's whole plan: that chunk, up to 64 splits): the
splits, and the device ms per call from torch.profiler (20 calls); then
the same at the kernel's plan (``ops.GQA_PLAN``, ``ops.MLA_PLAN``).
Each chunk's result is held against the plain version (o/l within 1e-3);
exit 1 on a miss.
"""
from __future__ import annotations

import subprocess
import sys
import time

import numpy as np
import torch

CHUNKS = (256, 512, 1024)
POS_MAIN = [4095, 0, 15, 16, 323, 3951, 2897, 3934]
POS_1K = [1030, 1024, 1040, 1000, 1035, 1029, 1031, 1050]


def device_ms(fn, calls: int = 20) -> float:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    # idle at both ends: the profiler drops a kernel whose device timestamps
    # fall just outside its window
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(0.02)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        time.sleep(0.02)
    return sum(e.time_range.end - e.time_range.start for e in prof.events()
               if e.device_type == DeviceType.CUDA) / calls / 1e3


def main() -> int:
    if not torch.cuda.is_available():
        print("paged_chunk_sweep: needs a CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels.paged_attention import ops, ref
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev, bf, ps, B, T = torch.device("cuda"), torch.bfloat16, 16, 8, 256
    rng = np.random.default_rng(0)
    g = torch.Generator(device=dev).manual_seed(0)
    N = 1 + B * T
    table = torch.tensor(1 + rng.permutation(N - 1).reshape(B, T),
                         dtype=torch.int32, device=dev)
    q = torch.randn((B, 8, 4, 128), generator=g, device=dev).to(bf)
    pk, pv = (torch.randn((N, ps, 8, 128), generator=g, device=dev).to(bf)
              for _ in range(2))
    qm = torch.randn((B, 128, 576), generator=g, device=dev).to(bf)
    pool = torch.randn((N, ps, 576), generator=g, device=dev).to(bf)
    kw = dict(page_size=ps, kv_lora=512, scale=192 ** -0.5)
    misses = 0
    for label, width, pos_h in (("§6 table", T, POS_MAIN),
                                ("~1k table", 128, POS_1K)):
        pt = table[:, :width].contiguous()
        pos = torch.tensor(pos_h, dtype=torch.int32, device=dev)
        calls = {
            "gqa": (lambda: ops.paged_attend_gqa(
                q, pk, pv, pt, pos, 0, page_size=ps, scale=128 ** -0.5),
                lambda: ref.paged_flash_decode_gqa_ref(
                    q, pk, pv, pt, pos, 0, page_size=ps, scale=128 ** -0.5)),
            "mla": (lambda: ops.paged_attend_mla(qm, pool, pt, pos, 0, **kw),
                    lambda: ref.paged_flash_decode_mla_ref(
                        qm, pool, pt, pos, 0, **kw))}
        for op, (fn, plain) in calls.items():
            o_r, _, l_r = plain()
            want = o_r / l_r[..., None]
            name = f"{op.upper()}_PLAN"
            plan = getattr(ops, name)
            for chunk in CHUNKS + (None,):
                setattr(ops, name, plan if chunk is None else (chunk, 64))
                o, _, l = fn()
                err = float((o / l[..., None] - want).abs().max())
                misses += err > 1e-3
                splits, keys = ops.split_plan(width, ps, getattr(ops, name))
                print(f"{op} {label} "
                      f"{'the plan' if chunk is None else 'chunk'} {keys} "
                      f"({splits} splits): device {device_ms(fn):.4f} ms, "
                      f"max |o/l - plain| {err:.2e}", flush=True)
            setattr(ops, name, plan)
    return 1 if misses else 0


if __name__ == "__main__":
    sys.exit(main())
