#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

1. Requires a CUDA device; prints the card's name and power limit.
2. Builds the hand-written kernels from this checkout (nvcc, sm_90a, one
   process per source, all started together), and prints for each kernel
   built on the tensor cores and asynchronous copies (the flash forward at
   its four instances, 256 included, dh 80 on the 128 one, the grouped
   GEMM's prefill and decode paths and paged MLA decode: wgmma and TMA,
   HGMMA and UTMALDG; paged GQA decode at dh 64, 128 and 256 and the flash
   backward's passes at (64, 64), (128, 128) and (192, 128): mma.sync and
   cp.async, HMMA and LDGSTS) those instructions in the SASS and its ptxas
   registers and spills; a count of 0 fails, and so does a spill of the
   (192, 128) backward passes.
3. Holds each kernel against its plain PyTorch version at the main paths'
   shapes (paged GQA decode at mistral's dh 128 and gemma2-2b's dh 256 with
   softcap 50, the latter also in f32 on the CUDA cores, paged MLA decode,
   flash prefill at GQA and MLA head dims (MLA also with the windowed
   variant's window of 1024, forward and backward), at gemma2-2b's dh 256 (window 4096, softcap 50), h2o-danube-1.8b's dh
   80 (the head dim zero-filled to 128) and whisper-large-v3's encoder (20
   heads over 20, dh 64, no mask, T 1500 and 448), each on the wgmma
   route, the grouped expert GEMM in bf16
   and f32 (and at jamba-v0.1-52b's
   expert shapes in bf16), the tiled GEMM on the hbb
   path's row chunks of a 1024² f32 GEMM and at 4096² in f32 and bf16 at
   each shape's plan, with the Table 2 sweep of bn, the SSD intra-chunk at
   mamba2-130m's shapes, the Mamba-1 selective scan at jamba's prefill
   shapes (B 1 and 8, S 2000, C 8192, N 16, a nonzero h0; its training
   instance, which also saves the state entering each 16-step tile, bit
   for bit the same; every scan instance unspilled and copying by
   cp.async; its bound the largest of bytes, f32 operations and exps on
   the special-function units), the scan's backward at jamba's training layer (B 2,
   S 2048, C 8192, N 16, nonzero h0 and dh_last) against the plain reverse
   recurrence and against autograd through the plain forward; the flash
   forward, the bf16 grouped GEMM, the SSD kernel and the selective scan
   also bit-equal over two calls; attention outputs row by row against the
   largest value of the row, a softcap with queries scaled so that the
   scores pass it and the kernel without it shown to miss), and times
   kernel, plain version and the
   PyTorch call that computes the same function, where there is one, with
   CUDA events; the paged decode kernels by their device time
   (torch.profiler after a warm-up cycle, one launch a call checked in the
   profile and by the wrapper's count; each profile opens with an
   uncounted lead-in kernel, and one that lost it is taken again) beside
   the wrapper's event time,
   with their route, splits and ptxas numbers.
   Then the paper's experiment (Fig. 5): HBB ``parallel_for`` over the
   rows of a 1024² f32 GEMM with the card's kernel as the accelerator
   class and host threads as the core class, every result checked against
   the plain product; offload-only against heterogeneous at 4096².
4. Serves full-width mistral-nemo-12b (seeded random weights made on the
   card) through the paged engine, each decode quantum one replay of a
   CUDA graph (one capture per live page-table width), twice, and checks
   that every request finishes with in-vocabulary tokens, the page pool is
   whole, its kernels were launched (a replay adds the launches its
   capture recorded), one capture per width, and the two runs give the
   same streams; profiles one replayed decode quantum; serves the workload
   once more through the eager loop (``graphs=False``), checks the streams
   are the same and profiles one eager quantum (busy share, kernels per
   step, the paged kernels seen equal to those counted); serves it sampled
   (temperature 0.8, top-k 50) through graphs and eagerly and checks the
   streams are equal; checks prefill → decode against a one-token-longer
   prefill at full width (f32, depth cut to 2 layers). Each serve run
   prints decode tok/s over the quanta that did not capture, the captures
   and their seconds and the widths used. Every engine the script builds
   is held to the memory helpers as it is built: ``reserved_cache_bytes()``
   equals its cache tensors' bytes and ``cache_bytes``/``page_bytes`` of
   its layout (printed once a layout). Then, over the same parameters,
   the heterogeneous tier pool (``serve/multi_engine.py``): a short-context
   dense tier and a long-context paged tier, each engine on its own CUDA
   stream, serve 24 requests (4 prompts only the long tier holds); with
   routing at the priors and admission pinned, a serial and a concurrent
   run (fresh engines; the long tier's first capture held open while the
   short tier steps) give the same assignments, streams and launch counts
   (the "pool" path of the kernels line), no health transition, one
   capture per width and whole page pools; measured routing, concurrent
   and serial, is reported (routed, decoded, tok/s, wall); the long tier's
   bf16 streams against one paged engine's are reported. At f32, depth
   cut to 2 layers, a raise fault on the short tier and a hang past the
   long tier's deadline: every stream as the unfailed pool's, the short
   tier quarantined → probation → healthy, no recapture, no page leaked.
   Then speculative big/little decode over the same parameters: the deep
   39 layers' ``wo`` and ``w_down`` scaled by 0.2 (``soften_deep_layers``)
   and a draft of the first layer (``draft_from_target``), a paged engine
   of 8 slots of 4096, quanta of 8 rounds of 4 proposals: the softened
   target alone through graphs (reference streams and tok/s); the
   speculative engine through graphs twice (every request done with 32
   in-vocabulary tokens, the pool whole, one capture per width, paged GQA
   and the flash forward launched on the "spec" path, each slot's device
   pos advanced by exactly the tokens the host appended, the same streams
   twice), eagerly (the same streams) and sampled (temperature 0.8, top-k
   50, the first 6 prompts: graphs = eager); reported beside the card:
   the bf16 streams equal to the target-only ones, tok/s, acceptance,
   tokens a round, one replayed quantum profiled (busy share, kernels a
   round) and one eager quantum's device ms of draft, verify, acceptance
   and commit. At f32, depth cut to 2 layers, ``decode_verify`` of 5
   tokens against 5 serial decode steps and ``decode_commit`` of 3
   against 3 serial writes, held to 1e-3; and greedy speculative streams
   through graphs held equal to the target alone's, the second layer
   scaled by 0.05 so that rounds emit more than one token. The paged
   kernels of step 3 are also held at a verify's rows (each slot's table
   repeated 5 times at its last committed position, a never-filled slot
   at position -1 merged to an empty row across the splits). Then serving
   across cards on the ``model`` axis (``sharded_phase``): on one card the
   main shape's paged GQA pools cut into 2 and 4 offset slices, the kernel
   on each at base i·16/m, the partials merged by
   ``decode.combine_shards`` and held against the unsharded kernel (each
   slice's device ms and their sum beside it); where the machine shows 2+
   cards, min(4, cards) NCCL ranks serve mistral-nemo-12b (and on 4
   cards phi3.5-moe-42b) at full width and published depth through CUDA
   graphs, their f32 depth-2 greedy streams held against one card's
   engine, bf16 tok/s and a replayed quantum's busy share printed; with
   one card a line says the multi-rank part did not run.
5. The same (graphs twice, eager once, both quanta profiled) for
   deepseek-v2-236b (MLA + MoE) at full width with depth cut to 6 layers
   (the dense first layer and 5 MoE layers), with the f32 prefill →
   decode check and the verify/commit check (paged MLA, MoE) with depth
   cut to 2 layers; and for mamba2-130m at its published width and depth
   (exact-length prefill through the SSD kernel, per-slot state), with
   the f32 checks at full depth (the verify's staged states); and for
   jamba-v0.1-52b (Mamba-1 + attention + MoE) at full width with depth
   cut to 8 layers (one whole period: 7 Mamba-1 layers, attention at slot
   4, MoE on the odd slots), the mistral workload through the paged
   engine (graphs twice, eager once, no kernel's plain version called on
   the card, both grouped-GEMM paths launched, the longest prompt's
   prefill group and a quantum profiled) and once through the dense
   engine (its streams reported beside the paged engine's), with the f32
   prefill → decode check at depth 8 through both layouts. Then
   speculative decode with that Mamba-1 target (``jamba_spec_phase``): its
   layers and a one-layer dense GQA draft at its width and vocab (sharing
   its embedding and unembedding) softened by 1e-3, spec_k 4, the jamba
   workload through graphs twice and eagerly (the three runs' streams
   equal, one capture per width, its kernels on the "jamba-spec" path, no
   plain version on the card) and once through the dense engine; spec
   tok/s, acceptance and tokens a round beside the target alone's; at
   f32, depth 8, greedy spec streams equal to the target alone's, paged
   and dense, with more than one token a round.
6. nemotron-4-15b (non-gated squared-ReLU FFN, paged engine, the mistral
   workload), gemma2-2b (paged engine at max_len 8192: 13 global layers in
   the pool, 13 window-4096 rings, post-norm, softcaps; 8 prompts of
   16-6000 tokens, two longer than the window) and h2o-danube-1.8b (the
   dense engine, ``paged=False``, rings of 4096 on every layer; gemma2's
   workload), each at published width and depth: once through CUDA graphs
   and once through the eager loop (streams checked equal, one quantum of
   each profiled), a check that gemma2's and danube's decode ran past
   position 4096, danube's longest prompt's prefill profiled (the flash
   forward's device ms, one launch a layer), and prefill → decode against
   a one-token-longer prefill
   (nemotron's bf16 at full depth reported, gemma2's held to 3e-2 through
   its paged layout; f32 at depth 2 held, past the window for gemma2 and
   danube, gemma2's through its dense and its paged layout, the latter on
   the CUDA-core kernel at dh 256; gemma2's verify/commit check past the
   window through its paged layout). Then mistral-nemo-12b at full width
   through the gathered-view decode (``gather_phase``,
   ``paged_kernel=False``): graphs and eager streams equal, no paged
   kernel launched, no plain version on the card, decode tok/s beside the
   kernel path's, and at f32 depth 2 the streams of the paged-kernel
   engine. Then whisper-large-v3 at published
   width and depth (32 + 32 layers) through ``prefill_step_fn`` and
   ``serve_step_fn``: 8 requests of 1500 stub frames encoded (the flash
   forward once an encoder layer on the wgmma route, no other kernel, no
   plain version on the card), a 4-token decoder prompt and 124 greedy
   steps (self and cross attention in plain torch), a profiled step and
   its cross attentions' device ms, and at f32 with depth cut to 2 + 2, 8
   steps held within 1e-3 of ``decode_hidden``; and internvl2-26b at
   published width and depth (48 layers, the 3200 → 6144 front-end
   projection): the mistral workload as text through the paged engine
   (graphs twice, a profiled quantum, eager once), 4 image requests (256
   patch positions + 16-512 text tokens, ``prefill(frontend_embed)`` into
   the paged layout and 32 greedy ``decode_step``s: the flash forward
   once a layer a prefill, paged GQA once a layer a step), and prefill(S,
   fe) + decode against prefill(S + 1, fe), reported in bf16 and held at
   f32 with depth cut to 2 (1e-3). Each model's weights are freed before
   the next. Every launch counts for the one kernel entry whose paths hold
   the model.
7. Training (the flash backward and the forward that saves lse, the
   grouped GEMM's backward products, the SSD intra-chunk under autograd,
   the selective scan's backward): both flash kernels against their plain
   versions at the GQA training shape (B=4, T=2048, 32 heads over 8,
   dh=128, causal, bf16; also f32 and window + softcap), at deepseek-v2's
   MLA shape (B=4, T=2048, 128 heads at (192, 128), the backward on the
   mma.sync passes), at whisper's encoder,
   decoder and cross shapes (G 1, dh 64; non-causal, causal, Tq 448 over
   Tk 1500) and internvl2's G 6, each call's route recorded, timed beside
   ``scaled_dot_product_attention`` and its backward; dA = dC·Wᵀ and dW =
   Aᵀ·dC through ``GroupedGemm`` at phi3.5-moe's, deepseek-v2's and
   jamba's (up and down) training shapes (bf16 and f32, one launch a
   product), timed beside ``torch.bmm`` and the transposes' copies; the
   SSD kernel at a mamba2 training layer's 64 chunk rows beside its plain
   backward. Then seven models at their published width,
   each trained 5 steps (batch B x 2048 of synthetic data through the
   prefetch loader, bf16 params, AdamW lr 0.15/d, whisper 0.0375/d) with
   per-step loss (and ``moe_aux``), grad norm, seconds and tokens/s, peak memory, model
   FLOP/s against the bf16 peak and one profiled step, their kernels'
   launches counted on their path, and an f32 gradient check at full
   width of the kernels against autograd through the plain versions:
   mistral-nemo-12b (depth 8, B 4, f32 moments; "train"), phi3.5-moe-42b
   (depth 3, B 4, f32 moments; "train-moe"), deepseek-v2-236b (depth 2:
   the dense layer and one MoE layer, B 4, int8 moments; "train-mla"),
   mamba2-130m (full depth, B 8, f32 moments; "train-ssm"),
   jamba-v0.1-52b (depth 5: Mamba-1 + dense, + MoE, + dense, + MoE,
   attention + dense, B 2, int8 moments; "train-hybrid"; f32 check at
   depth 2), whisper-large-v3 (full depth, 8 x 1500 stub frames and 448
   decoder tokens, f32 moments; "train-encdec"; f32 check at 2 + 2
   layers, 512 frames, 64 tokens) and internvl2-26b (depth 8, B 4, 256
   front-end positions, f32 moments; "train-vlm"; f32 check at depth 2
   with the front end); and the
   training launcher at smoke size, mistral-nemo-12b and phi3.5-moe-42b,
   each in a subprocess. Last, variants of registered models that no
   config uses (``variants_phase``, named as variants): phi3.5-moe-42b
   with a relu2 (non-gated) MoE at depth 2, jamba-v0.1-52b post-norm at
   depth 8, mamba2-130m post-norm at depth 2 (each served through graphs
   and eagerly with equal bf16 streams, and prefill → decode held at f32),
   and deepseek-v2-236b with a window of 1024 on even layers (trained
   only: the JAX reference serves windowed MLA wrongly); each trained 3
   steps at depth 2 with the f32 gradient check.
8. Prints report lines (``report {...}``: the f32 paged decode kernel at
   dh 256, each pool run and the speculative phase beside the card's
   name and power limit), one JSON line {"kernels": [...]} (each entry's
   launches by path, the pool's and the speculative engine's ("spec")
   among them), then as the last line {"ok": true, "device":
   {...}}. Any failed check exits non-zero without it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import io
import json
import math
import os
import subprocess
import sys
import time
from collections import Counter
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

HBM_BYTES_PER_S = 3.35e12                      # H100 SXM data sheet
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12,
                  "tf32": 495e12}
BF16_TOL = 3e-2          # as tests/test_kernels.py for bf16
# a bf16 attention output against the f32 reference: each row (query, head)
# within 1e-2 of its largest |value| (bf16 rounds to 2^-9 of a value)
ROW_TOL = 1e-2
F32_REL_TOL = 1e-4       # grouped GEMM in f32, as tests/test_kernels.py
FAILURES: list[str] = []
CARD = ""                # nvidia-smi's name and power limit, set in main
# MoE capacity couples the rows of a prefill group, so two serve runs give
# the same streams only if they form the same groups: the engines of this
# script admit with one fixed HBB speed ratio instead of the measured one
PINNED_F = 0.05


def check(ok: bool, what: str) -> None:
    print(("ok    " if ok else "FAIL  ") + what, flush=True)
    if not ok:
        FAILURES.append(what)


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# The profiler drops a kernel whose device timestamps, put on the host's
# clock, fall outside the profile's window ("Out-of-range" in its log): a
# kernel right at a profile's start or end. On an H100, 6 of 700 profiles
# of one short kernel lost it so; none of 700 with the host and the card
# idle for this long at each end.
PROFILE_PAD_S = 0.02
# On one H100 host every profile from a minute into the run lost its first
# kernel record (a 20-call profile saw 19 launches, a one-kernel profile
# none); on another one profile lost 3 of 21; most hosts lose none; on
# another, many profiles lost their first two records (a one-launch lead-in
# and a 20-call profile's first launch, three times running). So each
# profile starts with LEAD_IN_KERNELS lead-in kernels (``torch.cuda._sleep``'s
# spin kernel) that no reading counts: they take lost first records, and a
# profile with none of them left is known to have lost records
# (``kernels_ms`` profiles again, at most ``PROFILE_ATTEMPTS`` times).
LEAD_IN = "spin_kernel"
LEAD_IN_KERNELS = 4
LEAD_INS = {"profiles": 0, "lost": 0}
PROFILE_ATTEMPTS = 3


@contextmanager
def device_profile(cpu: bool = False):
    """torch.profiler over the block (CUDA, and CPU with ``cpu``), idle for
    ``PROFILE_PAD_S`` and ``LEAD_IN_KERNELS`` lead-in kernels (``LEAD_IN``)
    before it and, after a synchronize, idle after it."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    with profile(activities=acts) as prof:
        time.sleep(PROFILE_PAD_S)
        for _ in range(LEAD_IN_KERNELS):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        yield prof
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)


def kernels_ms(fn, calls: int = 1) -> tuple[dict[str, list], dict]:
    """``calls`` calls of ``fn`` under :func:`device_profile` → ({device
    kernel name: [ms, launches]}, {wrapper count of ``_counters``:
    launches}), all per call and of the same calls. A profile that lost
    its lead-in kernel is taken again (``PROFILE_ATTEMPTS`` in all)."""
    counters = _counters()

    def counts():
        return {n: getattr(mod, attr) for n, (mod, attr) in counters.items()}

    fn()
    torch.cuda.synchronize()
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        lost = LEAD_INS["lost"]
        with device_profile() as prof:
            n0 = counts()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        by_name = device_time(prof)[2]
        if LEAD_INS["lost"] == lost:
            break
        print(f"profile {attempt} of {calls} calls lost its lead-in kernels "
              f"(it saw {sum(n for _, n in by_name.values())} kernels)")
    counted = {n: (c - n0[n]) / calls for n, c in counts().items()}
    return ({k: [us / 1e3 / calls, n / calls]
             for k, (us, n) in by_name.items()}, counted)


def row_err(out, want) -> float:
    """Largest error of an output row (the last dim) relative to the row's
    largest |value| of the reference, over all rows."""
    out, want = out.float(), want.float()
    d = (out - want).abs().amax(-1)
    return float((d / want.abs().amax(-1).clamp_min(1e-30)).max())


def bound_ms(n_bytes: float, n_ops: float, dtype) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / PEAK_OPS_PER_S[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


# ------------------------------- SASS of the tensor-core kernels
# The kernels redesigned for Hopper's tensor cores and asynchronous copies,
# by the kernel entry of the "kernels" line whose path runs them: (library,
# {kernel label as _build.kernel_label gives it: (its tensor-core opcode,
# its asynchronous-copy opcode)}). wgmma + TMA: HGMMA, UTMALDG; mma.sync +
# cp.async: HMMA, LDGSTS.
WGMMA = ("HGMMA", "UTMALDG")
MMA = ("HMMA", "LDGSTS")
WGMMA_KERNELS = {
    "flash_attention_fwd": ("flash_attention", dict.fromkeys([
        "flash_fwd_wgmma<64, 64>", "flash_fwd_wgmma<128, 128>",
        "flash_fwd_wgmma<192, 128>"], WGMMA)),
    "flash_attention_fwd_lse": ("flash_attention", {
        "flash_fwd_wgmma<128, 128>": WGMMA}),
    "grouped_gemm": ("grouped_gemm", dict.fromkeys(
        ["gg_prefill", "gg_decode"], WGMMA)),
    "paged_attention_gqa": ("paged_attention", dict.fromkeys([
        f"paged_gqa_mma<{dh}, {cap}>" for dh in (64, 128) for cap in (0, 1)],
        ("HMMA", "LDGSTS"))),
    "paged_attention_gqa_dh256": ("paged_attention", dict.fromkeys([
        f"paged_gqa_mma<256, {cap}>" for cap in (0, 1)],
        ("HMMA", "LDGSTS"))),
    "flash_attention_fwd_dh256": ("flash_attention", {
        "flash_fwd_wgmma<256, 256>": WGMMA}),
    # dh 80: the (128, 128) instance, the head dim zero-filled by TMA
    "flash_attention_fwd_dh80": ("flash_attention", {
        "flash_fwd_wgmma<128, 128>": WGMMA}),
    "flash_attention_bwd": ("flash_attention_bwd", dict.fromkeys(
        ["bwd_dq_mma<128, 128>", "bwd_dkv_mma<128, 128>"], MMA)),
    "flash_attention_bwd_whisper": ("flash_attention_bwd", dict.fromkeys(
        ["bwd_dq_mma<64, 64>", "bwd_dkv_mma<64, 64>"], MMA)),
    "flash_attention_bwd_mla": ("flash_attention_bwd", dict.fromkeys(
        ["bwd_dq_mma<192, 128>", "bwd_dkv_mma<192, 128>"], MMA)),
    "paged_attention_mla": ("paged_attention", dict.fromkeys([
        "paged_mla_wgmma<512>", "paged_mla_wgmma<576>"], WGMMA)),
    "ssd_intra_chunk": ("ssd", {"ssd_mma": MMA}),
}
# instances held to no local-memory spill (ptxas)
NO_SPILL = ("bwd_dq_mma<192, 128>", "bwd_dkv_mma<192, 128>")


def sass_phase() -> dict[str, dict]:
    """Per redesigned kernel: its tensor-core and asynchronous-copy
    instructions in the built SASS (``cuobjdump -sass``) and ptxas's
    registers and spills. A count of 0 fails, and so does a spill of an
    instance in ``NO_SPILL``."""
    from repro_torch.kernels import _build
    libs = {lib for lib, _ in WGMMA_KERNELS.values()}
    sass = {lib: _build.sass_counts(lib) for lib in libs}
    out = {}
    for entry, (lib, kernels) in WGMMA_KERNELS.items():
        counts, regs = sass[lib], _build.ptxas_stats(lib)
        out[entry] = {}
        for k, ops in kernels.items():
            c, r = counts.get(k, {}), regs.get(k, {})
            out[entry][k] = {**c, **r}
            check(all(c.get(op, 0) > 0 for op in ops),
                  f"SASS of {k} ({lib}): " + ", ".join(
                      f"{c.get(op, 0)} {op}" for op in ops) +
                  f"; ptxas {r.get('registers')} registers, "
                  f"{r.get('spill_stores')} B spill stores, "
                  f"{r.get('spill_loads')} B spill loads")
            if k in NO_SPILL:
                check(r.get("spill_stores") == 0 == r.get("spill_loads"),
                      f"ptxas: {k} ({lib}) spills no local memory "
                      f"({r.get('registers')} registers)")
    return out


def paged_call(fn, kernel: str, counter: str, n_bytes: float,
               n_ops: float) -> dict:
    """Device and event times of a paged decode call and its kernel's
    ptxas numbers: device ms per call from torch.profiler (20 calls; one
    launch of ``kernel`` each, nothing else on the card, and one launch
    each by the wrapper's count ``counter``, checked), event ms
    of the wrapper (50 calls back to back: the host's cost where it exceeds
    the device's), GB/s and TFLOP/s on the device time."""
    from repro_torch.kernels import _build
    by_name, counted = kernels_ms(fn, 20)
    dev = sum(t for t, _ in by_name.values())
    one = len(by_name) == 1 and all(n == 1 and kernel in name
                                    for name, (_, n) in by_name.items())
    check(one and counted[counter] == 1, f"{kernel}: one launch per call, "
          f"nothing else on the card "
          f"({ {k[:60]: n for k, (_, n) in by_name.items()} }; counted "
          f"{counted[counter]})")
    label = _build.kernel_label(next(iter(by_name)))
    regs = _build.ptxas_stats("paged_attention").get(label, {})
    return {"kernel": label, "device_ms": dev,
            "event_ms": time_ms(fn, 50, 5), "GB_s": n_bytes / dev / 1e6,
            "TFLOP_s": n_ops / dev / 1e9, **regs}


# ------------------------------------------------------------ paged decode
def check_verify_rows(what: str, attend, plain, table, pos, q_row, dt,
                      splits: int) -> float:
    """A verify's call of a paged kernel at the served table, held: each
    slot's table repeated K = SPEC_K + 1 times at its last committed
    position pos0 - 1 (``decode._repeat_rows``), slot 1 never filled (pos0
    0, so position -1), B·K random query rows of shape ``q_row``. o/l (each
    row within 1e-3 of its largest value), m and l against the plain
    version on the same rows, the same rows live, and the empty rows
    merged across the ``splits`` to m = -1e30, l = 0, o = 0 → the largest
    |o/l - ref|."""
    from repro_torch.serve.decode import _repeat_rows
    K = SPEC_K + 1
    pos0 = pos + 1
    pos0[1] = 0
    ptf, posf = _repeat_rows(table, pos0, K)
    g = torch.Generator(device=table.device).manual_seed(1)
    q = torch.randn((ptf.shape[0],) + tuple(q_row), generator=g,
                    device=table.device).to(dt)
    o, m, l = attend(q, ptf, posf)
    o_r, m_r, l_r = plain(q, ptf, posf)
    live = l_r > 0
    ok_live = bool(torch.equal(live, l > 0))
    got = o[live] / l[live][:, None]
    want = o_r[live] / l_r[live][:, None]
    e = row_err(got, want)
    e_m = float((m - m_r).abs().max())
    e_l = float(((l - l_r).abs()[live] / l_r[live]).max())
    empty = posf < 0
    merged = bool((m[empty] == -1e30).all() and (l[empty] == 0).all()
                  and (o[empty] == 0).all())
    check(ok_live and e <= 1e-3 and e_m <= 1e-3 and e_l <= 1e-3
          and int(empty.sum()) == K and merged and splits > 1,
          f"{what} at a verify's rows ({ptf.shape[0]} = {table.shape[0]} "
          f"slots x {K}, table {tuple(ptf.shape)}, {splits} splits, "
          f"{int(empty.sum())} rows at position -1): |o/l - ref| {e:.3g} of "
          f"the row's largest, |m - ref| {e_m:.3g}, rel |l - ref| {e_l:.3g} "
          f"(tol 1e-3), live rows {'equal' if ok_live else 'DIFFER'}, "
          f"empty rows merged to m = -1e30, l = 0, o = 0: {merged}")
    return float((got.float() - want.float()).abs().max())


def paged_gqa_inputs(dev, *, hkv: int, grp: int, dh: int, max_len: int,
                     pos_head: list, dt) -> tuple:
    """Seeded inputs of a paged GQA decode at B=8, 16-token pages, a
    ``max_len``-key table: (q in f32, pools k and v in ``dt``, table, pos,
    pos as numpy), pos led by ``pos_head`` and the rest drawn."""
    B, ps = 8, 16
    T = max_len // ps
    N = 1 + B * T
    rng = np.random.default_rng(0)
    g = torch.Generator(device=dev).manual_seed(0)
    q32 = torch.randn((B, hkv, grp, dh), generator=g, device=dev)
    pk = torch.randn((N, ps, hkv, dh), generator=g, device=dev).to(dt)
    pv = torch.randn((N, ps, hkv, dh), generator=g, device=dev).to(dt)
    table = torch.tensor(1 + rng.permutation(N - 1).reshape(B, T),
                         dtype=torch.int32, device=dev)
    pos_h = np.concatenate([pos_head,
                            rng.integers(1, max_len, B - len(pos_head))])
    pos = torch.tensor(pos_h, dtype=torch.int32, device=dev)
    return q32, pk, pv, table, pos, pos_h


def hold_paged_gqa(inputs, *, grp: int, dh: int, caps: tuple, dt) -> float:
    """Paged GQA decode on ``inputs`` (:func:`paged_gqa_inputs`) held
    against the plain version for each (softcap, gain) of ``caps`` (see
    :func:`paged_gqa_entry`): o/l each row within 1e-3 of its largest, m
    and l within 1e-3; with a softcap and a gain the kernel without the
    softcap must miss. Returns max |o/l - ref|."""
    from repro_torch.kernels.paged_attention import ops, ref
    q32, pk, pv, table, pos, _ = inputs
    err = 0.0
    for softcap, gain in caps:
        qg = (q32 * gain).to(dt)
        kw = dict(page_size=pk.shape[1], scale=dh ** -0.5)
        o, m, l = ops.paged_attend_gqa(qg, pk, pv, table, pos, 0,
                                       softcap=softcap, **kw)
        o_r, m_r, l_r = ref.paged_flash_decode_gqa_ref(
            qg, pk, pv, table, pos, 0, softcap=softcap, **kw)
        want = o_r / l_r[..., None]
        e = row_err(o / l[..., None], want)
        e_m = float((m - m_r).abs().max())
        e_l = float(((l - l_r).abs() / l_r).max())
        err = max(err, float((o / l[..., None] - want).abs().max()))
        check(e <= 1e-3 and e_m <= 1e-3 and e_l <= 1e-3,
              f"paged decode ({ops.gqa_route(dt, grp, dh)}) dh={dh} G={grp} "
              f"softcap={softcap} q x {gain}: "
              f"|o/l - ref| {e:.3g} of the row's largest, |m - ref| "
              f"{e_m:.3g}, rel |l - ref| {e_l:.3g} (tol 1e-3)")
        if softcap and gain > 1:
            o0, _, l0 = ops.paged_attend_gqa(qg, pk, pv, table, pos, 0,
                                             softcap=0.0, **kw)
            e0 = row_err(o0 / l0[..., None], want)
            check(e0 > 1e-3, f"paged decode dh={dh} softcap={softcap} q x "
                  f"{gain}: the kernel without the softcap misses the "
                  f"reference by {e0:.3g} of a row's largest (> tol 1e-3): "
                  "the scores reach the cap")
    return err


def paged_gqa_entry(dev, *, name: str, hkv: int, grp: int, dh: int,
                    max_len: int, caps: tuple, cap: float, pos_head: list,
                    paths: list, dt=torch.bfloat16,
                    verify: bool = False) -> dict:
    """Paged GQA decode at B=8, 16-token pages, a ``max_len``-key table, in
    ``dt`` (bf16: the tensor cores at the served shapes; f32: the CUDA
    cores):
    held against the plain version for each (softcap, gain) of ``caps``
    (q scaled by gain: unit inputs give scores of std ~1, which a softcap of
    30 or 50 barely bends, so a softcap is held where scores reach it, and
    the kernel without it must miss), timed at ``cap`` (device time; one
    launch a call checked), and SDPA on the gathered K/V with the same keys
    live (``sdpa_gathered_ms``; not a library time: SDPA neither reads a
    page table nor returns partials). ``verify``: also held at a verify's
    rows (:func:`check_verify_rows`, softcap ``cap``)."""
    from repro_torch.kernels.paged_attention import ops, ref
    B, ps = 8, 16
    T = max_len // ps
    esz = torch.finfo(dt).bits // 8
    inputs = paged_gqa_inputs(dev, hkv=hkv, grp=grp, dh=dh, max_len=max_len,
                              pos_head=pos_head, dt=dt)
    q32, pk, pv, table, pos, pos_h = inputs
    q = q32.to(dt)
    scale = dh ** -0.5
    err = hold_paged_gqa(inputs, grp=grp, dh=dh, caps=caps, dt=dt)
    keys = int((pos_h + 1).sum())               # positions ≤ pos per slot
    n_bytes = (q.numel() * esz + 2 * keys * hkv * dh * esz
               + 4 * int(sum(-(-(p + 1) // ps) for p in pos_h)) + 4 * B
               + B * hkv * grp * (dh + 2) * 4)
    n_ops = 4 * keys * hkv * grp * dh
    b_ms, b_by = bound_ms(n_bytes, n_ops, dt)
    route = ops.gqa_route(dt, grp, dh)
    splits, chunk = ops.split_plan(T, ps, ops.GQA_PLAN)
    kw = dict(page_size=ps, scale=scale, softcap=cap)
    v_err = check_verify_rows(
        f"paged decode {route} dh={dh} G={grp}",
        lambda qr, tr, pr: ops.paged_attend_gqa(qr, pk, pv, tr, pr, 0, **kw),
        lambda qr, tr, pr: ref.paged_flash_decode_gqa_ref(
            qr, pk, pv, tr, pr, 0, **kw),
        table, pos, (hkv, grp, dh), dt, splits) if verify else None
    call = paged_call(lambda: ops.paged_attend_gqa(
        q, pk, pv, table, pos, 0, page_size=ps, scale=scale, softcap=cap),
        "paged_gqa", "paged_attention_gqa", n_bytes, n_ops)
    ms = call["device_ms"]
    plain = time_ms(lambda: ref.paged_flash_decode_gqa_ref(
        q, pk, pv, table, pos, 0, page_size=ps, scale=scale, softcap=cap),
        10)
    # SDPA over the gathered (B, Hkv, max_len, dh) K/V, keys <= pos live
    kg = pk[table.long()].reshape(B, max_len, hkv, dh).permute(0, 2, 1, 3)
    vg = pv[table.long()].reshape(B, max_len, hkv, dh).permute(0, 2, 1, 3)
    kg, vg = kg.contiguous(), vg.contiguous()
    qs = q.reshape(B, hkv * grp, 1, dh)
    live = (torch.arange(max_len, device=dev)[None] <= pos[:, None].long())
    mask = live[:, None, None, :]
    sdpa = time_ms(lambda: F.scaled_dot_product_attention(
        qs, kg, vg, attn_mask=mask, scale=scale, enable_gqa=True), 20)
    del kg, vg
    print(f"paged decode B={B} Hkv={hkv} G={grp} dh={dh} ps={ps} "
          f"softcap={cap} table {max_len} keys pos={pos_h.tolist()}: route "
          f"{route} ({call['kernel']}), {splits} splits of {chunk} keys: "
          f"device {ms:.4f} ms ({call['GB_s']:.1f} GB/s), event "
          f"{call['event_ms']:.4f} ms a call, plain {plain:.4f} ms, bound "
          f"{b_ms:.4f} ms ({b_by}), sdpa on the gathered K/V "
          f"{sdpa:.4f} ms; ptxas {call.get('registers')} registers, "
          f"{call.get('spill_stores')} B spill stores, "
          f"{call.get('spill_loads')} B spill loads")
    at_verify = "; and at a verify's B·K rows" if verify else ""
    entry = {"name": name, "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
             "replaces": "src/repro/kernels/paged_attention/"
                         "paged_attention.py:161",
             "counter": "paged_attention_gqa",
             "max_abs_err": err, "tol": 1e-3, "ms": ms, "plain_ms": plain,
             "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
             "sdpa_gathered_ms": sdpa, "verify_rows_err": v_err,
             "paged": {"route": route, "splits": splits, "chunk": chunk,
                       **call},
             "paths": paths,
             "check": f"o/l (each row within 1e-3 of its largest value), m, "
                      f"l against paged_flash_decode_gqa_ref, {dt} pools, "
                      f"B=8 Hkv={hkv} G={grp} dh={dh}, mixed pos up to "
                      f"{max_len - 1}, (softcap, q gain) {caps}, and with a "
                      f"gain the kernel without its softcap missing"
                      f"{at_verify}; "
                      f"max_abs_err is |o/l - ref|; ms is the device time "
                      f"at softcap {cap}"}
    return entry


def paged_phase(dev) -> dict:
    """mistral-nemo-12b's decode shape: Hkv=8, G=4, dh=128, a 4096-key
    table; checked at softcap 0 and 30 (scores to ~±100) and at the spec
    path's verify rows (B·K = 40), timed at 0. Its launches are mistral's,
    nemotron-4-15b's, jamba-v0.1-52b's and internvl2-26b's (dh 128;
    jamba's one attention layer of 8 has the same Hkv, G and dh;
    nemotron's and internvl2's G is 6, held beside it at the same table,
    softcaps and gains, not timed)."""
    caps, pos_head = ((0.0, 1), (30.0, 25)), [4095, 0, 15, 16]
    e = paged_gqa_entry(dev, name="paged_attention_gqa", hkv=8, grp=4,
                        dh=128, max_len=4096, caps=caps, cap=0.0,
                        pos_head=pos_head,
                        paths=["mistral-nemo-12b", "nemotron-4-15b", "pool",
                               "spec", "jamba-v0.1-52b", "internvl2-26b",
                               "internvl2-26b images", "jamba-spec",
                               "variant moe-relu2",
                               "variant jamba-postnorm"],
                        verify=True)
    # nemotron's and internvl2's G 6: held the same way, not timed
    e["g6_err"] = hold_paged_gqa(
        paged_gqa_inputs(dev, hkv=8, grp=6, dh=128, max_len=4096,
                         pos_head=pos_head, dt=torch.bfloat16),
        grp=6, dh=128, caps=caps, dt=torch.bfloat16)
    e["max_abs_err"] = max(e["max_abs_err"], e["g6_err"])
    e["check"] += ("; and the same checks at G=6 (nemotron's and "
                   "internvl2's), not timed")
    return e


def paged256_phase(dev) -> dict:
    """gemma2-2b's global-layer decode: Hkv=4, G=2, dh=256, softcap 50, an
    8192-key table; checked at softcap 0 and 50 (unit scores and scores to
    ~±120), timed at 50. Its launches are gemma2's."""
    return paged_gqa_entry(dev, name="paged_attention_gqa_dh256", hkv=4,
                           grp=2, dh=256, max_len=8192,
                           caps=((0.0, 1), (50.0, 1), (50.0, 30)),
                           cap=50.0, pos_head=[8191, 0, 15, 16, 4095, 4096],
                           paths=["gemma2-2b"])


def paged256_f32_report(dev) -> dict:
    """The CUDA-core kernel at gemma2-2b's global-layer shape in f32 (the
    path of the f32 paged checks at dh 256: paged_gqa_kernel<float, 2,
    256>): held and timed as paged256_phase, printed as a report line
    (its launches are counted with the dh-256 entry's, on no serve
    path)."""
    e = paged_gqa_entry(dev, name="paged_attention_gqa_f32_dh256", hkv=4,
                        grp=2, dh=256, max_len=8192,
                        caps=((0.0, 1), (50.0, 1), (50.0, 30)), cap=50.0,
                        pos_head=[8191, 0, 15, 16, 4095, 4096], paths=[],
                        dt=torch.float32)
    check(e["paged"]["route"] == "f32", "f32 paged decode at dh 256 takes "
          f"the CUDA cores ({e['paged']['kernel']})")
    report = {k: e[k] for k in ("name", "max_abs_err", "ms", "plain_ms",
                                "bound_ms", "bound_by", "sdpa_gathered_ms")}
    print("report " + json.dumps({**report, "kernel": e["paged"]["kernel"],
                                  "event_ms": e["paged"]["event_ms"]}))
    return report


# ------------------------------------------------------------ flash prefill
def flash_phase(dev) -> dict:
    """GQA prefill shapes of mistral-nemo-12b (B=8, H=32, Hkv=8, dh=128),
    of nemotron-4-15b and internvl2-26b (H=48, Hkv=8: held, not timed) and
    the MLA prefill shape of deepseek-v2-236b (H=128, G=1, q/k dim 192 =
    nope 128 + rope 64, v dim 128, v a strided slice as prefill passes
    it), also at the windowed variant's training shape (B=2, T=2048,
    window 1024: held and timed, not the entry's time). Each output row within ``ROW_TOL`` of its largest value of the f32
    reference; the softcap case with q scaled by 20 (scores to ~±80, past
    the cap of 30), where the kernel without its softcap must miss."""
    from repro_torch.kernels.flash_attention import ops, ref
    dt = torch.bfloat16
    err, main, mla = 0.0, None, None
    for B, H, Hk, dh, dv, T, causal, window, softcap, gain in (
            (8, 32, 8, 128, 128, 1024, True, 0, 0.0, 1),
            (8, 32, 8, 128, 128, 2048, True, 0, 0.0, 1),
            (8, 32, 8, 128, 128, 1024, True, 256, 30.0, 20),
            (8, 32, 8, 128, 128, 1000, True, 0, 0.0, 1),
            (8, 32, 8, 64, 64, 1024, True, 0, 0.0, 1),
            (8, 128, 128, 192, 128, 1024, True, 0, 0.0, 1),
            (2, 128, 128, 192, 128, 2048, True, 1024, 0.0, 1)):
        scale = dh ** -0.5
        g = torch.Generator(device=dev).manual_seed(T + window + dh)
        # the prefill's layout: (B, T, heads, d) memory, head-major views
        q = (gain * torch.randn((B, T, H, dh), generator=g,
                                device=dev)).to(dt)
        k = torch.randn((B, T, Hk, dh), generator=g, device=dev).to(dt)
        if dv == dh:
            v = torch.randn((B, T, Hk, dv), generator=g, device=dev).to(dt)
        else:   # MLA: v is the tail of the up-projected (nope + v) rows
            v = torch.randn((B, T, Hk, 128 + dv), generator=g,
                            device=dev).to(dt)[..., 128:]
        qv, kv, vv = (x.permute(0, 2, 1, 3) for x in (q, k, v))
        kw = dict(scale=scale, causal=causal, window=window, softcap=softcap)
        route = ops.fwd_route(dt, dh, dv, True)
        what = (f"flash ({route}) H={H} dh={dh} dv={dv} T={T} causal="
                f"{causal} window={window} softcap={softcap} q x {gain}")
        err = max(err, check_flash(ops, ref, qv, kv, vv, kw, gain, what))
        rows = np.arange(T)
        lo = np.maximum(0, rows - window + 1) if window else np.zeros(T)
        hi = rows if causal else np.full(T, T - 1)
        pairs = int((hi - lo + 1).sum())
        n_ops = 2 * (dh + dv) * pairs * B * H
        n_bytes = 2 * B * T * (H * dh + Hk * (dh + dv) + H * dv)
        b_ms, b_by = bound_ms(n_bytes, n_ops, dt)
        ms = time_ms(lambda: ops.attend(qv, kv, vv, **kw), 10)
        plain = time_ms(lambda: ref.flash_attention_ref(qv, kv, vv, **kw), 2,
                        1)
        lib = None
        if not window and not softcap:
            qc, kc, vc = qv.contiguous(), kv.contiguous(), vv.contiguous()
            lib = time_ms(lambda: F.scaled_dot_product_attention(
                qc, kc, vc, is_causal=causal, scale=scale,
                enable_gqa=Hk != H), 10)
            del qc, kc, vc
        print(f"flash B={B} H={H} Hkv={Hk} dh={dh} dv={dv} T={T} "
              f"window={window} softcap={softcap}: kernel {ms:.4f} ms, plain "
              f"{plain:.4f} ms, sdpa {lib if lib is None else round(lib, 4)} "
              f"ms, bound {b_ms:.4f} ms ({b_by}), "
              f"{n_ops / ms / 1e9:.2f} TFLOP/s")
        if main is None:
            main = (ms, plain, b_ms, b_by, lib)
        if dh != dv and not window:
            mla = {"shape": f"B={B} H={H} dqk={dh} dv={dv} T={T} causal",
                   "ms": ms, "plain_ms": plain, "bound_ms": b_ms,
                   "bound_by": b_by, "library_ms": lib}
        del q, k, v, qv, kv, vv
        torch.cuda.empty_cache()
    # nemotron's and internvl2's prefill, H 48 over 8 (G 6): held, not timed
    for B, T in ((8, 1024), (1, 783)):
        g = torch.Generator(device=dev).manual_seed(T + 6)
        qv, kv, vv = (torch.randn((B, T, h, 128), generator=g, device=dev)
                      .to(dt).permute(0, 2, 1, 3) for h in (48, 8, 8))
        kw = dict(scale=128 ** -0.5, causal=True, window=0, softcap=0.0)
        route = ops.fwd_route(dt, 128, 128, ops._aligned(qv, kv, vv))
        check(route == "wgmma", f"flash B={B} H=48 Hkv=8 dh=128 T={T}: the "
              f"(B, T, heads, d) views take the wgmma route ({route})")
        err = max(err, check_flash(ops, ref, qv, kv, vv, kw, 1,
                                   f"flash ({route}) B={B} H=48 Hkv=8 "
                                   f"dh=dv=128 T={T} causal"))
        del qv, kv, vv
        torch.cuda.empty_cache()
    ms, plain, b_ms, b_by, lib = main
    return {"name": "flash_attention_fwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/"
                        "flash_attention.py:92",
            "paths": ["mistral-nemo-12b", "deepseek-v2-236b",
                      "nemotron-4-15b", "pool", "spec", "jamba-v0.1-52b",
                      "internvl2-26b", "internvl2-26b images", "jamba-spec",
                      "variant moe-relu2", "variant jamba-postnorm",
                      "gather"],
            "max_abs_err": err, "tol": ROW_TOL, "ms": ms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib,
            "mla": mla,
            "check": "out (bf16) against flash_attention_ref in f32, each "
                     "row within 1e-2 of its largest value; max_abs_err is "
                     "|out - ref|: B=8 H=32 Hkv=8 dh=128: T=1024/2048 "
                     "causal, window 256 + softcap 30 with q x 20 (the "
                     "kernel without its softcap must miss), ragged "
                     "T=1000; dh=64 T=1024 causal; B=8 H=128 dqk=192 "
                     "dv=128 T=1024 causal; H=48 Hkv=8 dh=128 causal at "
                     "B=8 T=1024 and B=1 T=783 (wgmma route, not timed); "
                     "two calls bit-equal at each; "
                     "times at B=8 H=32 T=1024 causal (mla: the MLA shape)"}


def check_flash(ops, ref, qv, kv, vv, kw, gain, what: str) -> float:
    """The flash forward (bf16) on q, k, v against the plain version in
    f32: each output row within ``ROW_TOL`` of its largest value, two calls
    bit-equal; with a softcap and q scaled up (scores past the cap), the
    kernel without the softcap must miss by more than the tolerance.
    Returns max |out - ref|."""
    out = ops.attend(qv, kv, vv, **kw)
    same = torch.equal(out, ops.attend(qv, kv, vv, **kw))
    want = ref.flash_attention_ref(qv.float(), kv.float(), vv.float(), **kw)
    e = row_err(out, want)
    check(e <= ROW_TOL and same, f"{what}: |out - ref| {e:.3g} of the "
          f"row's largest (tol {ROW_TOL}), two calls bit-equal {same}")
    if kw["softcap"] and gain > 1:
        e0 = row_err(ops.attend(qv, kv, vv, **{**kw, "softcap": 0.0}), want)
        check(e0 > ROW_TOL, f"{what}: the kernel without the softcap misses "
              f"the reference by {e0:.3g} of a row's largest (> tol "
              f"{ROW_TOL}): the scores reach the cap")
    e_abs = float((out.float() - want).abs().max())
    del out, want
    torch.cuda.empty_cache()
    return e_abs


# ------------------------------------- flash prefill at head dims 256 and 80
def _band_mask(T: int, window: int, dev):
    """(T, T) bool: key <= row, and key > row - window when windowed."""
    i = torch.arange(T, device=dev)[:, None]
    j = torch.arange(T, device=dev)[None, :]
    ok = j <= i
    return ok & (j > i - window) if window else ok


def flash_dims_entry(dev, *, name: str, H: int, Hk: int, d: int,
                     cases: tuple, paths: list) -> dict:
    """The flash forward at head dim ``d`` (= dv) on the wgmma route
    (checked): each case (B, T, window, softcap, q gain) held by
    :func:`check_flash`; the first case also timed (CUDA events) beside the
    plain
    version and ``scaled_dot_product_attention`` with the same mask (SDPA
    has no softcap: it computes the masked softmax without it)."""
    from repro_torch.kernels.flash_attention import ops, ref
    dt = torch.bfloat16
    err, timed = 0.0, None
    for B, T, window, softcap, gain in cases:
        g = torch.Generator(device=dev).manual_seed(T + window + d)
        q = (gain * torch.randn((B, T, H, d), generator=g,
                                device=dev)).to(dt)
        k = torch.randn((B, T, Hk, d), generator=g, device=dev).to(dt)
        v = torch.randn((B, T, Hk, d), generator=g, device=dev).to(dt)
        qv, kv, vv = (x.permute(0, 2, 1, 3) for x in (q, k, v))
        kw = dict(scale=d ** -0.5, causal=True, window=window,
                  softcap=softcap)
        route = ops.fwd_route(dt, d, d, ops._aligned(qv, kv, vv))
        check(route == "wgmma", f"flash B={B} H={H} Hkv={Hk} dh={d} T={T}: "
              f"the (B, T, heads, d) views take the wgmma route ({route})")
        err = max(err, check_flash(
            ops, ref, qv, kv, vv, kw, gain, f"flash ({route}) B={B} H={H} "
            f"Hkv={Hk} dh=dv={d} T={T} window={window} softcap={softcap} "
            f"q x {gain}"))
        if timed is None:
            rows = np.arange(T)
            lo = np.maximum(0, rows - window + 1) if window else np.zeros(T)
            pairs = int((rows - lo + 1).sum())
            n_ops = 4 * d * pairs * B * H
            n_bytes = 2 * B * T * (2 * H * d + 2 * Hk * d)
            b_ms, b_by = bound_ms(n_bytes, n_ops, dt)
            ms = time_ms(lambda: ops.attend(qv, kv, vv, **kw), 10)
            plain = time_ms(lambda: ref.flash_attention_ref(qv, kv, vv,
                                                            **kw), 2, 1)
            qc, kc, vc = qv.contiguous(), kv.contiguous(), vv.contiguous()
            if window and window < T:
                mask = _band_mask(T, window, dev)
                lib = time_ms(lambda: F.scaled_dot_product_attention(
                    qc, kc, vc, attn_mask=mask, scale=d ** -0.5,
                    enable_gqa=Hk != H), 10)
            else:                   # the band is the causal mask
                lib = time_ms(lambda: F.scaled_dot_product_attention(
                    qc, kc, vc, is_causal=True, scale=d ** -0.5,
                    enable_gqa=Hk != H), 10)
            del qc, kc, vc
            print(f"flash ({route}) B={B} H={H} Hkv={Hk} dh=dv={d} T={T} "
                  f"window={window} softcap={softcap}: kernel {ms:.4f} ms, "
                  f"plain {plain:.4f} ms, sdpa (same mask, no softcap) "
                  f"{lib:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
                  f"{n_ops / ms / 1e9:.2f} TFLOP/s")
            timed = (ms, plain, b_ms, b_by, lib, route,
                     f"B={B} H={H} Hkv={Hk} dh=dv={d} T={T} "
                     f"window={window} softcap={softcap}")
        del q, k, v, qv, kv, vv
        torch.cuda.empty_cache()
    ms, plain, b_ms, b_by, lib, route, shape = timed
    return {"name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/"
                        "flash_attention.py:92",
            "counter": "flash_attention_fwd", "paths": paths,
            "kernel_route": route,
            "max_abs_err": err, "tol": ROW_TOL, "ms": ms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib,
            "check": "out (bf16) against flash_attention_ref in f32, each "
                     "row within 1e-2 of its largest value (max_abs_err is "
                     "|out - ref|), causal, the wgmma route, cases (B, T, "
                     "window, softcap, q gain) " + str(list(cases)) +
                     "; with a softcap and a "
                     "gain the kernel without its softcap must miss; two "
                     "calls bit-equal; times at " + shape +
                     "; library: scaled_dot_product_attention with the same "
                     "mask, no softcap"}


def flash256_phase(dev) -> dict:
    """gemma2-2b's prefill: 8 heads over 4, dh = dv = 256, softcap 50,
    window 4096 on the local layers; the wgmma route (64-key tiles); q
    scaled by 30 in two cases (scores to ~±120, past the cap). Its launches
    are gemma2's."""
    return flash_dims_entry(
        dev, name="flash_attention_fwd_dh256", H=8, Hk=4, d=256,
        cases=((8, 4096, 4096, 50.0, 1), (2, 8192, 4096, 50.0, 30),
               (2, 8192, 0, 50.0, 30), (2, 1000, 300, 0.0, 1)),
        paths=["gemma2-2b"])


def flash80_phase(dev) -> dict:
    """h2o-danube-1.8b's prefill: 32 heads over 8, dh = dv = 80, window
    4096; the wgmma route on the (128, 128) instance, the head dim
    zero-filled to 128 in shared memory. Its launches are danube's."""
    return flash_dims_entry(
        dev, name="flash_attention_fwd_dh80", H=32, Hk=8, d=80,
        cases=((2, 4096, 4096, 0.0, 1), (1, 8192, 4096, 0.0, 1),
               (2, 1000, 300, 0.0, 1)),
        paths=["h2o-danube-1.8b"])


def flash_whisper_phase(dev) -> dict:
    """whisper-large-v3's encoder attention: 20 heads over 20 (G 1), dh =
    dv = 64, no mask (``causal=False``), T 1500 (23 key tiles of 64 and a
    ragged 28) and 448, the (B, T, 20, 64) projections as head-transposed
    views; the wgmma route. Each case held by :func:`check_flash`; B 8, T
    1500 (the served shape) timed beside the plain version and
    ``scaled_dot_product_attention`` with no mask. Its launches are
    whisper's encoder's, one a layer."""
    from repro_torch.kernels.flash_attention import ops, ref
    dt, H, d = torch.bfloat16, 20, 64
    err, timed = 0.0, None
    for B, T in ((8, 1500), (2, 448), (2, 1500)):
        g = torch.Generator(device=dev).manual_seed(T + B)
        q, k, v = (torch.randn((B, T, H, d), generator=g, device=dev).to(dt)
                   for _ in range(3))
        qv, kv, vv = (x.permute(0, 2, 1, 3) for x in (q, k, v))
        kw = dict(scale=d ** -0.5, causal=False, window=0, softcap=0.0)
        route = ops.fwd_route(dt, d, d, ops._aligned(qv, kv, vv))
        check(route == "wgmma", f"flash B={B} H={H} Hkv={H} dh={d} T={T} "
              f"non-causal: the (B, T, heads, d) views take the wgmma route "
              f"({route})")
        err = max(err, check_flash(ops, ref, qv, kv, vv, kw, 1,
                                   f"flash ({route}) B={B} H={H} Hkv={H} "
                                   f"dh=dv={d} T={T} non-causal"))
        if timed is None:
            n_ops = 4 * d * T * T * B * H
            n_bytes = 2 * B * T * 4 * H * d
            b_ms, b_by = bound_ms(n_bytes, n_ops, dt)
            ms = time_ms(lambda: ops.attend(qv, kv, vv, **kw), 10)
            plain = time_ms(lambda: ref.flash_attention_ref(qv, kv, vv,
                                                            **kw), 2, 1)
            qc, kc, vc = qv.contiguous(), kv.contiguous(), vv.contiguous()
            lib = time_ms(lambda: F.scaled_dot_product_attention(
                qc, kc, vc, scale=d ** -0.5), 10)
            del qc, kc, vc
            print(f"flash ({route}) B={B} H={H} Hkv={H} dh=dv={d} T={T} "
                  f"non-causal: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
                  f"sdpa (no mask) {lib:.4f} ms, bound {b_ms:.4f} ms "
                  f"({b_by}), {n_ops / ms / 1e9:.2f} TFLOP/s")
            timed = (ms, plain, b_ms, b_by, lib, route)
        del q, k, v, qv, kv, vv
        torch.cuda.empty_cache()
    ms, plain, b_ms, b_by, lib, route = timed
    return {"name": "flash_attention_fwd_whisper", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/"
                        "flash_attention.py:92",
            "counter": "flash_attention_fwd", "paths": ["whisper-large-v3"],
            "kernel_route": route,
            "max_abs_err": err, "tol": ROW_TOL, "ms": ms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib,
            "check": "out (bf16) against flash_attention_ref in f32, each "
                     "row within 1e-2 of its largest value (max_abs_err is "
                     "|out - ref|), 20 heads over 20, dh 64, non-causal, "
                     "(B, T) in (8, 1500), (2, 448), (2, 1500); the wgmma "
                     "route; two calls bit-equal; times at B=8 T=1500; "
                     "library: scaled_dot_product_attention, no mask"}


# ------------------------------------------------ flash backward (training)
def _causal_pairs(T: int, window: int) -> int:
    rows = np.arange(T)
    lo = np.maximum(0, rows - window + 1) if window else np.zeros(T)
    return int((rows - lo + 1).sum())


def flash_bwd_phase(dev) -> list[dict]:
    """The training path's attention shape: B=4, T=2048, H=32 over Hkv=8,
    dh=128, causal, bf16, q/k/v/do as head-transposed views of (B, T, heads,
    d) as ``attend`` passes them; also f32 (CUDA cores) and window 256 +
    softcap 30. The forward with lse against ``flash_attention_fwd_lse_ref``
    (lse within 1e-4; o bit-equal to the serving forward), the backward
    against ``flash_attention_bwd_ref`` on the kernel's own o and lse (each
    gradient within 3e-2 of its largest value in bf16, 1e-4 in f32). Times
    of the bf16 causal case: the kernels, the plain versions, and the
    library: ``scaled_dot_product_attention`` (enable_gqa) with inputs that
    want a gradient (its forward keeps lse), and its backward through
    ``torch.autograd.grad`` on a graph made outside the timed region."""
    from repro_torch.kernels.flash_attention import ops, ref
    B, T, H, Hk, dh = 4, 2048, 32, 8, 128
    scale = dh ** -0.5
    err_f, err_b, main = 0.0, 0.0, None
    bwd_passes = {}
    for dt, window, softcap in ((torch.bfloat16, 0, 0.0),
                                (torch.float32, 0, 0.0),
                                (torch.bfloat16, 256, 30.0)):
        g = torch.Generator(device=dev).manual_seed(7 + window)
        q, do = (torch.randn((B, T, H, dh), generator=g, device=dev).to(dt)
                 for _ in range(2))
        k, v = (torch.randn((B, T, Hk, dh), generator=g, device=dev).to(dt)
                for _ in range(2))
        qv, kv, vv, dov = (x.permute(0, 2, 1, 3) for x in (q, k, v, do))
        kw = dict(scale=scale, causal=True, window=window, softcap=softcap)
        o, lse = ops.attend_fwd_lse(qv, kv, vv, **kw)
        same = torch.equal(o, ops.attend(qv, kv, vv, **kw))
        _, lse_r = ref.flash_attention_fwd_lse_ref(qv, kv, vv, **kw)
        e_l = float((lse - lse_r).abs().max())
        err_f = max(err_f, e_l)
        label = (f"B={B} T={T} H={H} Hkv={Hk} dh={dh} {dt} window={window} "
                 f"softcap={softcap}")
        check(same and e_l <= 1e-4, f"flash fwd lse {label}: o equals the "
              f"serving forward {same}, max |lse - ref| {e_l:.3g} (tol 1e-4)")
        del lse_r
        got = ops.attend_bwd(qv, kv, vv, o, lse, dov, **kw)
        want = ref.flash_attention_bwd_ref(qv, kv, vv, o, lse, dov, **kw)
        tol = BF16_TOL if dt == torch.bfloat16 else F32_REL_TOL
        errs = [float((a.float() - b.float()).abs().max()
                      / b.float().abs().max()) for a, b in zip(got, want)]
        err_b = max(err_b, max(errs))
        check(max(errs) <= tol, f"flash bwd {label}: dq, dk, dv relative "
              f"max error {[f'{e:.3g}' for e in errs]} (tol {tol})")
        del got, want
        torch.cuda.empty_cache()
        if main is not None:
            continue
        pairs = _causal_pairs(T, window) * B * H
        e = 2                                      # bf16 bytes
        b_bytes = (e * B * T * (3 * H * dh + 2 * Hk * dh) + 4 * B * H * T
                   + e * B * T * (H * dh + 2 * Hk * dh))
        f_bytes = e * B * T * (2 * H * dh + 2 * Hk * dh) + 4 * B * H * T
        bb = bound_ms(b_bytes, 10 * dh * pairs, dt)
        fb = bound_ms(f_bytes, 4 * dh * pairs, dt)
        ms_b = time_ms(lambda: ops.attend_bwd(qv, kv, vv, o, lse, dov, **kw),
                       10)
        again = ops.attend_bwd(qv, kv, vv, o, lse, dov, **kw)
        same = all(torch.equal(x, y) for x, y in zip(
            again, ops.attend_bwd(qv, kv, vv, o, lse, dov, **kw)))
        check(same, f"flash bwd {label}: two calls bit-equal")
        del again
        passes = {}
        for name, (ms, n) in kernels_ms(lambda: ops.attend_bwd(
                qv, kv, vv, o, lse, dov, **kw))[0].items():
            key = ("dq pass" if "bwd_dq" in name else "dk/dv pass"
                   if "bwd_dkv" in name else "delta" if "delta" in name
                   else name[:40])
            passes[key] = ms
        print(f"flash bwd {label}, one profiled call, device ms: "
              + ", ".join(f"{k} {v:.4f}" for k, v in passes.items()))
        plain_b = time_ms(lambda: ref.flash_attention_bwd_ref(
            qv, kv, vv, o, lse, dov, **kw), 2, 1)
        ms_f = time_ms(lambda: ops.attend_fwd_lse(qv, kv, vv, **kw), 10)
        plain_f = time_ms(lambda: ref.flash_attention_fwd_lse_ref(
            qv, kv, vv, **kw), 2, 1)
        qc, kc, vc = (x.contiguous().requires_grad_() for x in (qv, kv, vv))
        sdpa = dict(is_causal=True, scale=scale, enable_gqa=True)
        lib_f = time_ms(lambda: F.scaled_dot_product_attention(
            qc, kc, vc, **sdpa), 10)
        out = F.scaled_dot_product_attention(qc, kc, vc, **sdpa)
        doc = dov.contiguous()
        lib_b = time_ms(lambda: torch.autograd.grad(
            out, (qc, kc, vc), doc, retain_graph=True), 10)
        del out, qc, kc, vc, doc
        for what, ms, plain, (b_ms, b_by), lib, flops in (
                ("bwd", ms_b, plain_b, bb, lib_b, 10 * dh * pairs),
                ("fwd lse", ms_f, plain_f, fb, lib_f, 4 * dh * pairs)):
            print(f"flash {what} {label}: kernel {ms:.4f} ms "
                  f"({flops / ms / 1e9:.2f} TFLOP/s), plain {plain:.4f} ms, "
                  f"sdpa {lib:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
                  f"kernel/bound {ms / b_ms:.1f}x, kernel/sdpa "
                  f"{ms / lib:.1f}x")
        main = ((ms_b, plain_b, *bb, lib_b), (ms_f, plain_f, *fb, lib_f))
        bwd_passes = passes
        del q, k, v, do, qv, kv, vv, dov, o, lse
        torch.cuda.empty_cache()
    shape = (f"B={B} T={T} H={H} Hkv={Hk} dh={dh} causal bf16, q/k/v/do "
             "head-transposed views")
    out = []
    for name, replaces, (ms, plain, b_ms, b_by, lib), err, tol, chk in (
            ("flash_attention_bwd", "flash_attention_bwd.py:138", main[0],
             err_b, BF16_TOL,
             "dq, dk, dv against flash_attention_bwd_ref on the kernel's o "
             "and lse, relative to each largest value: bf16 (tol 3e-2) "
             "causal and window 256 + softcap 30, f32 (tol 1e-4) causal; "
             "library: the backward of scaled_dot_product_attention "
             "(enable_gqa) through torch.autograd.grad"),
            ("flash_attention_fwd_lse", "flash_attention_bwd.py:199",
             main[1], err_f, 1e-4,
             "lse against flash_attention_fwd_lse_ref (tol 1e-4), o bit-equal "
             "to the serving forward, the same three cases; library: "
             "scaled_dot_product_attention (enable_gqa) on inputs that want "
             "a gradient")):
        out.append({"name": name, "route": "cuda",
                    "source": "src/repro_torch/kernels/csrc/" + (
                        "flash_attention_bwd.cu" if name.endswith("bwd")
                        else "flash_attention.cu"),
                    "replaces": "src/repro/kernels/flash_attention/" + replaces,
                    "paths": ["train", "train-moe", "train-hybrid",
                              "train-vlm", "train-moe-relu2"],
                    "max_abs_err": err, "tol": tol, "ms": ms,
                    "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
                    "library_ms": lib, "check": f"{chk}; times at {shape}"})
    out[0]["passes_ms"] = bwd_passes
    return out


def flash_mla_train_phase(dev) -> list[dict]:
    """deepseek-v2's training attention: B=4, T=2048, H=128 at G=1, dqk
    192, dv 128, causal, bf16, as ``mla_attention`` passes it (q and k
    head-transposed views, v a view into the up-projection's rows), held
    with window 1024 (the windowed variant's even layers) and without. The
    lse forward (``wgmma``) and the backward (``mma``: the mma.sync passes
    at (192, 128); both routes checked) against the plain versions, each
    batch row on its own (a row's f32 scores take 2.1 GB): lse within
    1e-4, o bit-equal to the serving forward, dq, dk, dv within 3e-2 of
    each largest value, two backward calls bit-equal; unwindowed, one
    launch of each pass a profiled call. Times, unwindowed: kernels and the
    plain versions (over the four rows) by CUDA events; library:
    ``scaled_dot_product_attention`` on inputs that want a gradient and its
    backward through ``torch.autograd.grad``."""
    from repro_torch.kernels.flash_attention import ops, ref
    B, T, H, dqk, dv = 4, 2048, 128, 192, 128
    dt = torch.bfloat16
    scale = dqk ** -0.5
    g = torch.Generator(device=dev).manual_seed(11)
    q = torch.randn((B, T, H, dqk), generator=g, device=dev).to(dt)
    k = torch.randn((B, T, H, dqk), generator=g, device=dev).to(dt)
    kv = torch.randn((B, T, H, 256), generator=g, device=dev).to(dt)
    do = torch.randn((B, T, H, dv), generator=g, device=dev).to(dt)
    qv, kv_, vv, dov = (x.permute(0, 2, 1, 3)
                        for x in (q, k, kv[..., 128:], do))
    for window in (1024, 0):         # windowed first: the causal case's
        kw = dict(scale=scale, causal=True, window=window)  # outputs stay
        with flash_routes() as fwd_r, flash_routes("bwd_route") as bwd_r:
            o, lse = ops.attend_fwd_lse(qv, kv_, vv, **kw)
            got = ops.attend_bwd(qv, kv_, vv, o, lse, dov, **kw)
        same = torch.equal(o, ops.attend(qv, kv_, vv, **kw))
        bit = all(torch.equal(a, b) for a, b in zip(
            got, ops.attend_bwd(qv, kv_, vv, o, lse, dov, **kw)))

        def rows(fn, i):
            return fn(*(x[i:i + 1] for x in (qv, kv_, vv)), **kw)

        e_l, errs = 0.0, [0.0, 0.0, 0.0]
        for i in range(B):
            e_l = max(e_l, float((lse[i:i + 1] - rows(
                ref.flash_attention_fwd_lse_ref, i)[1]).abs().max()))
            want = ref.flash_attention_bwd_ref(
                *(x[i:i + 1] for x in (qv, kv_, vv, o, lse, dov)), **kw)
            for j, (a, b) in enumerate(zip(got, want)):
                errs[j] = max(errs[j], float(
                    (a[i:i + 1].float() - b.float()).abs().max()
                    / b.float().abs().max()))
            del want
        label = (f"B={B} T={T} H={H} (dqk, dv)=({dqk}, {dv}) causal "
                 + (f"window={window} " if window else "") + "bf16")
        check(fwd_r == ["wgmma"] and bwd_r == ["mma"], f"flash {label}: "
              f"routes fwd {fwd_r} bwd {bwd_r} (want wgmma, mma)")
        check(same and e_l <= 1e-4, f"flash fwd lse {label}: o equals the "
              f"serving forward {same}, max |lse - ref| {e_l:.3g} (tol "
              f"1e-4)")
        check(max(errs) <= BF16_TOL and bit, f"flash bwd {label}: dq, dk, "
              f"dv relative max error {[f'{e:.3g}' for e in errs]} (tol "
              f"{BF16_TOL}), two calls bit-equal {bit}")
        if window:
            e_win = (e_l, max(errs))
            del o, lse
    del got
    torch.cuda.empty_cache()
    pairs = _causal_pairs(T, 0) * B * H
    b_bytes = 2 * B * T * H * (2 * dqk + 3 * dv) + 4 * B * H * T + \
        2 * B * T * H * (2 * dqk + dv)
    f_bytes = 2 * B * T * H * (2 * dqk + 2 * dv) + 4 * B * H * T
    b_ops, f_ops = (6 * dqk + 4 * dv) * pairs, 2 * (dqk + dv) * pairs
    bb = bound_ms(b_bytes, b_ops, dt)
    fb = bound_ms(f_bytes, f_ops, dt)
    ms_b = time_ms(lambda: ops.attend_bwd(qv, kv_, vv, o, lse, dov, **kw), 10)
    from repro_torch.kernels import _build
    passes, labels = {}, {}
    for name, (ms, n) in kernels_ms(lambda: ops.attend_bwd(
            qv, kv_, vv, o, lse, dov, **kw))[0].items():
        key = ("dq pass" if "bwd_dq" in name else "dk/dv pass"
               if "bwd_dkv" in name else "delta" if "delta" in name
               else name[:40])
        passes[key] = ms
        labels[_build.kernel_label(name)] = n
    want = {"bwd_dq_mma<192, 128>": 1, "bwd_dkv_mma<192, 128>": 1,
            "delta_kernel<__nv_bfloat16>": 1}
    check(labels == want, f"flash bwd {label}: one launch of each pass a "
          f"call ({labels})")
    plain_b = time_ms(lambda: [ref.flash_attention_bwd_ref(
        *(x[i:i + 1] for x in (qv, kv_, vv, o, lse, dov)), **kw)
        for i in range(B)], 1, 1)
    ms_f = time_ms(lambda: ops.attend_fwd_lse(qv, kv_, vv, **kw), 10)
    plain_f = time_ms(lambda: [rows(ref.flash_attention_fwd_lse_ref, i)
                               for i in range(B)], 1, 1)
    qc, kc, vc = (x.contiguous().requires_grad_() for x in (qv, kv_, vv))
    sdpa = dict(is_causal=True, scale=scale)
    lib_f = time_ms(lambda: F.scaled_dot_product_attention(qc, kc, vc,
                                                           **sdpa), 10)
    out = F.scaled_dot_product_attention(qc, kc, vc, **sdpa)
    doc = dov.contiguous()
    lib_b = time_ms(lambda: torch.autograd.grad(
        out, (qc, kc, vc), doc, retain_graph=True), 10)
    del out, qc, kc, vc, doc
    print(f"flash bwd {label}, one profiled call, device ms: "
          + ", ".join(f"{k} {v:.4f}" for k, v in passes.items()))
    for what, ms, plain, (b_ms, b_by), lib, flops in (
            ("bwd", ms_b, plain_b, bb, lib_b, b_ops),
            ("fwd lse", ms_f, plain_f, fb, lib_f, f_ops)):
        print(f"flash {what} {label}: kernel {ms:.4f} ms "
              f"({flops / ms / 1e9:.2f} TFLOP/s), plain {plain:.4f} ms, "
              f"sdpa {lib:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
              f"kernel/bound {ms / b_ms:.1f}x, kernel/sdpa {ms / lib:.1f}x")
    del q, k, kv, do, qv, kv_, vv, dov, o, lse
    torch.cuda.empty_cache()
    shape = f"{label}, q/k/do head-transposed views, v a view of (.., 256)"
    out = []
    for name, counter, src, replaces, (ms, plain, (b_ms, b_by), lib), err, \
            tol, chk in (
            ("flash_attention_bwd_mla", "flash_attention_bwd",
             "flash_attention_bwd.cu", "flash_attention_bwd.py:138",
             (ms_b, plain_b, bb, lib_b), max(errs + [e_win[1]]), BF16_TOL,
             "dq, dk, dv against flash_attention_bwd_ref on the kernel's o "
             "and lse, each batch row, relative to each largest value (tol "
             "3e-2), causal and with window 1024; the mma route (bwd_dq_mma, bwd_dkv_mma at (192, 128)), "
             "two calls bit-equal, one launch of each pass a call; library: "
             "the backward of scaled_dot_product_attention through "
             "torch.autograd.grad"),
            ("flash_attention_fwd_lse_mla", "flash_attention_fwd_lse",
             "flash_attention.cu", "flash_attention_bwd.py:199",
             (ms_f, plain_f, fb, lib_f), max(e_l, e_win[0]), 1e-4,
             "lse against flash_attention_fwd_lse_ref, each batch row (tol "
             "1e-4), causal and with window 1024, o bit-equal to the serving forward; library: "
             "scaled_dot_product_attention on inputs that want a gradient")):
        out.append({"name": name, "counter": counter, "route": "cuda",
                    "source": "src/repro_torch/kernels/csrc/" + src,
                    "replaces": "src/repro/kernels/flash_attention/" + replaces,
                    "paths": ["train-mla", "train-mla-window"],
                    "kernel_route": (bwd_r if "bwd" in name else fwd_r)[0],
                    "max_abs_err": err, "tol": tol, "ms": ms,
                    "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
                    "library_ms": lib, "check": f"{chk}; times at {shape}"})
    out[0]["passes_ms"] = passes
    return out


# the flash backward and lse forward at the shapes of the new training
# cells: whisper's encoder (non-causal), decoder self (causal) and cross
# attention (non-causal, Tq != Tk) at G 1, dh 64; internvl2's G 6, dh 128
FLASH_TRAIN_SHAPES = (  # name, B, Tq, Tk, H, Hk, dh, causal
    ("whisper encoder", 8, 1500, 1500, 20, 20, 64, False),
    ("whisper decoder self", 8, 448, 448, 20, 20, 64, True),
    ("whisper cross", 8, 448, 1500, 20, 20, 64, False),
    ("internvl2", 4, 2048, 2048, 48, 8, 128, True))


def flash_train_case(dev, name, B, Tq, Tk, H, Hk, dh, causal) -> dict:
    """One shape of FLASH_TRAIN_SHAPES, bf16, q/k/v/do head-transposed
    views of (B, T, heads, dh) as ``attend`` passes them: the lse forward
    on ``wgmma`` (o bit-equal to the serving forward, lse within 1e-4 of
    ``flash_attention_fwd_lse_ref``) and the backward on ``mma`` (dq, dk, dv
    within 3e-2 of each largest value of ``flash_attention_bwd_ref`` on the
    kernel's o and lse, two calls bit-equal), each call's route recorded;
    CUDA-event ms of both kernels, their plain versions and
    ``scaled_dot_product_attention`` (forward on inputs that want a
    gradient; backward through ``torch.autograd.grad``), and the bounds."""
    from repro_torch.kernels.flash_attention import ops, ref
    dt = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(Tq + Tk + H)
    q, do = (torch.randn((B, Tq, H, dh), generator=g, device=dev).to(dt)
             .permute(0, 2, 1, 3) for _ in range(2))
    k, v = (torch.randn((B, Tk, Hk, dh), generator=g, device=dev).to(dt)
            .permute(0, 2, 1, 3) for _ in range(2))
    kw = dict(scale=dh ** -0.5, causal=causal)
    with flash_routes() as fwd_r, flash_routes("bwd_route") as bwd_r:
        o, lse = ops.attend_fwd_lse(q, k, v, **kw)
        got = ops.attend_bwd(q, k, v, o, lse, do, **kw)
        again = ops.attend_bwd(q, k, v, o, lse, do, **kw)
    same_o = torch.equal(o, ops.attend(q, k, v, **kw))
    bit = all(torch.equal(a, b) for a, b in zip(got, again))
    _, lse_r = ref.flash_attention_fwd_lse_ref(q, k, v, **kw)
    e_l = float((lse - lse_r).abs().max())
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
    errs = [float((a.float() - b.float()).abs().max() / b.float().abs().max())
            for a, b in zip(got, want)]
    del lse_r, want, again
    label = (f"{name} (B={B} Tq={Tq} Tk={Tk} H={H} Hkv={Hk} dh={dh} "
             f"{'causal' if causal else 'non-causal'} bf16)")
    check(fwd_r == ["wgmma"] and bwd_r == ["mma", "mma"] and same_o and
          e_l <= 1e-4 and max(errs) <= BF16_TOL and bit,
          f"flash train {label}: routes fwd {fwd_r} bwd {bwd_r} (want "
          f"wgmma, mma); o equals the serving forward {same_o}; max |lse - "
          f"ref| {e_l:.3g} (tol 1e-4); dq, dk, dv relative max error "
          f"{[f'{e:.3g}' for e in errs]} (tol {BF16_TOL}); two backward "
          f"calls bit-equal {bit}")
    pairs = _causal_pairs(Tq, 0) * B * H if causal else B * H * Tq * Tk
    e = 2
    b_bytes = (e * B * (3 * Tq * H * dh + 2 * Tk * Hk * dh) + 4 * B * H * Tq
               + e * B * (Tq * H * dh + 2 * Tk * Hk * dh))
    f_bytes = e * B * (2 * Tq * H * dh + 2 * Tk * Hk * dh) + 4 * B * H * Tq
    res = {"shape": label, "routes": {"fwd": fwd_r, "bwd": bwd_r[0]},
           "err_lse": e_l, "err_bwd": max(errs)}
    ms_b = time_ms(lambda: ops.attend_bwd(q, k, v, o, lse, do, **kw), 10)
    ms_f = time_ms(lambda: ops.attend_fwd_lse(q, k, v, **kw), 10)
    plain_b = time_ms(lambda: ref.flash_attention_bwd_ref(
        q, k, v, o, lse, do, **kw), 2, 1)
    plain_f = time_ms(lambda: ref.flash_attention_fwd_lse_ref(
        q, k, v, **kw), 2, 1)
    qc, kc, vc = (x.contiguous().requires_grad_() for x in (q, k, v))
    sdpa = dict(is_causal=causal, scale=dh ** -0.5, enable_gqa=H != Hk)
    lib_f = time_ms(lambda: F.scaled_dot_product_attention(
        qc, kc, vc, **sdpa), 10)
    out = F.scaled_dot_product_attention(qc, kc, vc, **sdpa)
    doc = do.contiguous()
    lib_b = time_ms(lambda: torch.autograd.grad(
        out, (qc, kc, vc), doc, retain_graph=True), 10)
    for what, ms, plain, n_bytes, flops, lib in (
            ("bwd", ms_b, plain_b, b_bytes, 10 * dh * pairs, lib_b),
            ("fwd_lse", ms_f, plain_f, f_bytes, 4 * dh * pairs, lib_f)):
        b_ms, b_by = bound_ms(n_bytes, flops, dt)
        res[what] = {"ms": ms, "plain_ms": plain, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": lib}
        print(f"flash {what} {label}: kernel {ms:.4f} ms "
              f"({flops / ms / 1e9:.2f} TFLOP/s), plain {plain:.4f} ms, "
              f"sdpa {lib:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
              f"kernel/bound {ms / b_ms:.1f}x, kernel/sdpa {ms / lib:.1f}x")
    del q, k, v, do, o, lse, got, qc, kc, vc, out, doc
    torch.cuda.empty_cache()
    return res


def flash_train_shapes_phase(dev) -> tuple[list[dict], dict]:
    """:func:`flash_train_case` at every FLASH_TRAIN_SHAPES → (the kernel
    entries of whisper's head dim, 64: ``flash_attention_bwd_whisper`` and
    ``flash_attention_fwd_lse_whisper``, timed at the encoder's shape with
    all three shapes listed; internvl2's G 6 result, which ``main`` adds to
    the dh-128 entries of :func:`flash_bwd_phase`)."""
    cases = [flash_train_case(dev, *shape) for shape in FLASH_TRAIN_SHAPES]
    whisper, g6 = cases[:3], cases[3]
    out = []
    for name, counter, src, replaces, key, err_key, tol, chk in (
            ("flash_attention_bwd_whisper", "flash_attention_bwd",
             "flash_attention_bwd.cu", "flash_attention_bwd.py:138", "bwd",
             "err_bwd", BF16_TOL,
             "dq, dk, dv against flash_attention_bwd_ref on the kernel's o "
             "and lse, relative to each largest value (tol 3e-2), at "
             "whisper's encoder, decoder self and cross shapes on the mma "
             "route, two calls bit-equal; library: the backward of "
             "scaled_dot_product_attention through torch.autograd.grad"),
            ("flash_attention_fwd_lse_whisper", "flash_attention_fwd_lse",
             "flash_attention.cu", "flash_attention_bwd.py:199", "fwd_lse",
             "err_lse", 1e-4,
             "lse against flash_attention_fwd_lse_ref (tol 1e-4), o "
             "bit-equal to the serving forward, the same three shapes on "
             "the wgmma route; library: scaled_dot_product_attention on "
             "inputs that want a gradient")):
        main = whisper[0][key]
        out.append({"name": name, "counter": counter, "route": "cuda",
                    "source": "src/repro_torch/kernels/csrc/" + src,
                    "replaces": "src/repro/kernels/flash_attention/" + replaces,
                    "paths": ["train-encdec"],
                    "max_abs_err": max(c[err_key] for c in whisper),
                    "tol": tol, **main,
                    "shapes": [{"shape": c["shape"], **c[key]}
                               for c in whisper],
                    "check": f"{chk}; times at {whisper[0]['shape']}"})
    return out, g6


# ------------------------------------------------------- paged MLA decode
def mla_phase(dev) -> dict:
    """deepseek-v2's absorbed decode: B=8, H=128, R=576, kv_lora 512,
    page 16, positions up to 4095 with 0, ps - 1 and ps, base 0 and 8;
    and at a verify's B·K rows (:func:`check_verify_rows`)."""
    from repro_torch.kernels.paged_attention import ops, ref
    B, H, lora, rope, ps, max_len = 8, 128, 512, 64, 16, 4096
    R = lora + rope
    T = max_len // ps
    N = 1 + B * T
    rng = np.random.default_rng(0)
    dt = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn((B, H, R), generator=g, device=dev).to(dt)
    pool = torch.randn((N, ps, R), generator=g, device=dev).to(dt)
    table = torch.tensor(1 + rng.permutation(N - 1).reshape(B, T),
                         dtype=torch.int32, device=dev)
    pos_h = np.concatenate([[max_len - 1, 0, ps - 1, ps],
                            rng.integers(1, max_len, B - 4)])
    pos = torch.tensor(pos_h, dtype=torch.int32, device=dev)
    scale = (128 + rope) ** -0.5
    kw = dict(page_size=ps, kv_lora=lora, scale=scale)
    err = 0.0
    for base in (0, ps // 2):
        o, m, l = ops.paged_attend_mla(q, pool, table, pos, base, **kw)
        o_r, m_r, l_r = ref.paged_flash_decode_mla_ref(q, pool, table, pos,
                                                       base, **kw)
        live = l_r > 0
        ok_live = bool(torch.equal(live, l > 0))
        e = float((o[live] / l[live][:, None]
                   - o_r[live] / l_r[live][:, None]).abs().max())
        e_m = float((m - m_r).abs().max())
        e_l = float(((l - l_r).abs()[live] / l_r[live]).max())
        err = max(err, e)
        check(ok_live and e <= 1e-3 and e_m <= 1e-3 and e_l <= 1e-3,
              f"paged MLA decode base={base}: |o/l - ref| {e:.3g}, |m - ref| "
              f"{e_m:.3g}, rel |l - ref| {e_l:.3g} (tol 1e-3)")
    keys = int((pos_h + 1).sum())
    n_bytes = (q.numel() * 2 + keys * R * 2
               + 4 * int(sum(-(-(p + 1) // ps) for p in pos_h)) + 4 * B
               + B * H * (lora + 2) * 4)
    n_ops = 2 * keys * H * (R + lora)
    b_ms, b_by = bound_ms(n_bytes, n_ops, dt)
    route = ops.mla_route(dt, H, R, lora, ps)
    splits, chunk = ops.split_plan(T, ps, ops.MLA_PLAN)
    v_err = check_verify_rows(
        f"paged MLA decode {route}",
        lambda qr, tr, pr: ops.paged_attend_mla(qr, pool, tr, pr, 0, **kw),
        lambda qr, tr, pr: ref.paged_flash_decode_mla_ref(qr, pool, tr, pr,
                                                           0, **kw),
        table, pos, (H, R), dt, splits)
    call = paged_call(lambda: ops.paged_attend_mla(
        q, pool, table, pos, 0, **kw), "paged_mla", "paged_attention_mla",
        n_bytes, n_ops)
    ms = call["device_ms"]
    plain = time_ms(lambda: ref.paged_flash_decode_mla_ref(
        q, pool, table, pos, 0, **kw), 10)
    print(f"paged MLA decode B={B} H={H} R={R} kv_lora={lora} ps={ps} "
          f"pos={pos_h.tolist()}: route {route} ({call['kernel']}), "
          f"{splits} splits of {chunk} keys: device {ms:.4f} ms "
          f"({call['TFLOP_s']:.2f} TFLOP/s, {call['GB_s']:.1f} GB/s), event "
          f"{call['event_ms']:.4f} ms a call, plain {plain:.4f} ms, bound "
          f"{b_ms:.4f} ms ({b_by}; on f32 CUDA cores "
          f"{1e3 * n_ops / PEAK_OPS_PER_S[torch.float32]:.4f} ms); ptxas "
          f"{call.get('registers')} registers, {call.get('spill_stores')} B "
          f"spill stores, {call.get('spill_loads')} B spill loads")
    return {"name": "paged_attention_mla", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
            "replaces": "src/repro/kernels/paged_attention/"
                        "paged_attention.py:213",
            "paths": ["deepseek-v2-236b"],
            "max_abs_err": err, "tol": 1e-3, "ms": ms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "verify_rows_err": v_err,
            "paged": {"route": route, "splits": splits, "chunk": chunk,
                      **call},
            "check": "o/l, m, l against paged_flash_decode_mla_ref, bf16 "
                     "pool, B=8 H=128 R=576 kv_lora=512 page 16, mixed pos "
                     "up to 4095, base 0 and 8, and at a verify's B·K rows; "
                     "ms is the device time"}


# ------------------------------------------------------------ grouped GEMM
def gg_phase(dev) -> dict:
    """deepseek-v2's expert products: prefill up/gate (160, 384, 5120) x
    (160, 5120, 1536) and down (160, 384, 1536) x (160, 1536, 5120) at the
    capacity of 8 rows x 1024 tokens; decode (M = 8, a broadcast with
    stride 0); a ragged M. bf16 within 3e-2 and f32 within 1e-4 of the
    largest value, against the plain version."""
    from repro_torch.kernels.grouped_gemm import ops, ref
    E, D, Fe = 160, 5120, 1536
    err, main, decode = 0.0, None, None
    for name, M, K, N, bcast in (("prefill up", 384, D, Fe, False),
                                 ("prefill down", 384, Fe, D, False),
                                 ("decode up", 8, D, Fe, True),
                                 ("decode down", 8, Fe, D, False),
                                 ("ragged", 100, D, Fe, False)):
        g = torch.Generator(device=dev).manual_seed(M + K)
        if bcast:
            x = torch.randn((M, K), generator=g, device=dev)
            a32 = x.unsqueeze(0).expand(E, M, K)
        else:
            a32 = torch.randn((E, M, K), generator=g, device=dev)
        w32 = torch.randn((E, K, N), generator=g, device=dev) * K ** -0.5
        res = {}
        for dt, tol in ((torch.float32, F32_REL_TOL), (torch.bfloat16,
                                                       BF16_TOL)):
            if dt == torch.float32 and name.startswith("decode"):
                continue            # f32 at the prefill shapes and ragged
            a, w = a32.to(dt), w32.to(dt)
            if bcast:
                a = x.to(dt).unsqueeze(0).expand(E, M, K)
            out = ops.grouped_gemm(a, w)
            same = torch.equal(out, ops.grouped_gemm(a, w))
            want = ref.grouped_gemm_ref(a, w)
            e = float((out.float() - want.float()).abs().max()
                      / want.float().abs().max())
            check(e <= tol and same, f"grouped GEMM ({ops.route(dt, M)}) "
                  f"{name} ({E}, {M}, {K}) x ({E}, {K}, {N}) "
                  f"{'stride-0 a ' if bcast else ''}{dt}: relative max error "
                  f"{e:.3g} (tol {tol}), two calls bit-equal {same}")
            if dt == torch.bfloat16:
                err = max(err, e)
                res = dict(a=a, w=w)
            del out, want
        a, w = res["a"], res["w"]
        a_bytes = (M * K if bcast else E * M * K) * 2
        n_bytes = a_bytes + E * K * N * 2 + E * M * N * 2
        n_ops = 2 * E * M * K * N
        b_ms, b_by = bound_ms(n_bytes, n_ops, torch.bfloat16)
        ms = time_ms(lambda: ops.grouped_gemm(a, w), 10)
        plain = time_ms(lambda: ref.grouped_gemm_ref(a, w), 3, 1)
        lib = time_ms(lambda: torch.bmm(a, w), 10)
        print(f"grouped GEMM {name} E={E} M={M} K={K} N={N} bf16: kernel "
              f"{ms:.4f} ms, plain {plain:.4f} ms, torch.bmm {lib:.4f} ms, "
              f"bound {b_ms:.4f} ms ({b_by}), {n_ops / ms / 1e9:.2f} "
              f"TFLOP/s, {n_bytes / ms / 1e6:.1f} GB/s")
        if main is None:
            main = (ms, plain, b_ms, b_by, lib)
        if name == "decode up":
            decode = {"shape": f"({E}, {M}, {K}) x ({E}, {K}, {N}), a with "
                               "expert stride 0",
                      "ms": ms, "plain_ms": plain, "bound_ms": b_ms,
                      "bound_by": b_by, "library_ms": lib}
        del a32, w32, a, w, res
        torch.cuda.empty_cache()
    ms, plain, b_ms, b_by, lib = main
    return {"name": "grouped_gemm", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/grouped_gemm.cu",
            "replaces": "src/repro/kernels/grouped_gemm/grouped_gemm.py:34",
            "paths": ["deepseek-v2-236b", "train-moe", "train-mla",
                      "jamba-v0.1-52b", "train-hybrid", "jamba-spec",
                      "variant moe-relu2", "variant jamba-postnorm",
                      "train-moe-relu2", "train-jamba-postnorm",
                      "train-mla-window"],
            "max_abs_err": err, "tol": BF16_TOL, "ms": ms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib,
            "decode": decode, "backward": gg_backward(dev),
            "jamba": gg_jamba(dev),
            "check": "relative max error against grouped_gemm_ref, bf16 "
                     "(tol 3e-2; two calls bit-equal) and f32 (tol 1e-4): "
                     "(160,384,5120)x(160,5120,1536), (160,384,1536)x"
                     "(160,1536,5120), decode M=8 with stride-0 a, ragged "
                     "M=100; times (library: torch.bmm) at the first shape "
                     "(decode: decode up); backward: dA and dW through "
                     "GroupedGemm at phi3.5-moe's and deepseek-v2's "
                     "training shapes, bf16 and f32, one launch a product; "
                     "jamba: jamba-v0.1-52b's expert products (bf16, tol "
                     "3e-2), prefill at a 2000-token row's capacity and "
                     "decode at 8 slots"}


# jamba-v0.1-52b's expert products: 16 experts, d 4096, expert hidden 14336;
# a 2000-token exact-length prefill row routes top-2 with capacity factor
# 1.25, so Ce = ceil(2000 * 2 * 1.25 / 16) = 313 rows an expert; decode runs
# every expert on the 8 slots' tokens (moe_decode), a stride-0 broadcast
GG_JAMBA_SHAPES = (("prefill up", 313, 4096, 14336, False),
                   ("prefill down", 313, 14336, 4096, False),
                   ("decode up", 8, 4096, 14336, True),
                   ("decode down", 8, 14336, 4096, False))


def gg_jamba(dev) -> list[dict]:
    """The grouped GEMM at GG_JAMBA_SHAPES in bf16: relative max error
    against the plain version (tol 3e-2), the route it takes, one launch a
    call; event ms of kernel, plain version and torch.bmm beside the
    bound."""
    from repro_torch.kernels.grouped_gemm import ops, ref
    E, out = 16, []
    for name, M, K, N, bcast in GG_JAMBA_SHAPES:
        g = torch.Generator(device=dev).manual_seed(M + K)
        if bcast:
            a = torch.randn((M, K), generator=g, device=dev).to(
                torch.bfloat16).unsqueeze(0).expand(E, M, K)
        else:
            a = torch.randn((E, M, K), generator=g, device=dev).to(
                torch.bfloat16)
        w = (torch.randn((E, K, N), generator=g, device=dev) * K ** -0.5).to(
            torch.bfloat16)
        n0 = ops.launches
        got = ops.grouped_gemm(a, w)
        one = ops.launches == n0 + 1
        want = ref.grouped_gemm_ref(a, w)
        e = float((got.float() - want.float()).abs().max()
                  / want.float().abs().max())
        route = ops.route(torch.bfloat16, M)
        check(e <= BF16_TOL and one and route == name.split()[0],
              f"grouped GEMM ({route}) jamba {name} ({E}, {M}, {K}) x ({E}, "
              f"{K}, {N}) bf16: relative max error {e:.3g} (tol "
              f"{BF16_TOL}), one launch {one}")
        del got, want
        n_bytes = ((M * K if bcast else E * M * K) + E * K * N + E * M * N) * 2
        n_ops = 2 * E * M * K * N
        b_ms, b_by = bound_ms(n_bytes, n_ops, torch.bfloat16)
        ms = time_ms(lambda: ops.grouped_gemm(a, w), 10)
        plain = time_ms(lambda: ref.grouped_gemm_ref(a, w), 2, 1)
        lib = time_ms(lambda: torch.bmm(a, w), 10)
        print(f"grouped GEMM jamba {name} E={E} M={M} K={K} N={N} bf16 "
              f"({route}): kernel {ms:.4f} ms, plain {plain:.4f} ms, "
              f"torch.bmm {lib:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
              f"{n_bytes / ms / 1e6:.1f} GB/s")
        out.append({"shape": f"{name} ({E}, {M}, {K}) x ({E}, {K}, {N})",
                    "route": route, "rel_err": e, "ms": ms, "plain_ms": plain,
                    "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib})
        del a, w
        torch.cuda.empty_cache()
    return out


# The expert products' shapes in training (the up projection), at 4 x 2048
# tokens: phi3.5-moe (16 experts of 6400, top-2, capacity 1280) and
# deepseek-v2 (160 of 1536, top-6, capacity 384)
# (name, E, M, K, N); jamba's M is the capacity of 2 x 2048 tokens at top-2
# and factor 1.25 (models/moe.py)
GG_TRAIN_SHAPES = (("phi3.5-moe up", 16, 1280, 4096, 6400),
                   ("deepseek-v2 up", 160, 384, 5120, 1536),
                   ("jamba up", 16, 640, 4096, 14336),
                   ("jamba down", 16, 640, 14336, 4096))


def gg_backward(dev) -> dict:
    """The grouped GEMM's backward products at GG_TRAIN_SHAPES through
    ``GroupedGemm``: dA = dC·Wᵀ and dW = Aᵀ·dC against the plain version,
    bf16 within 3e-2 and f32 within 1e-4 of the largest value, and one
    launch a product (forward and backward: 3). Times (bf16, CUDA events):
    each product on the kernel from its contiguous transposed operand,
    the plain version, ``torch.bmm`` on the transposed views, and the
    transposes' copies with their bytes."""
    from repro_torch.kernels.grouped_gemm import ops, ref
    res = {}
    for name, E, M, K, N in GG_TRAIN_SHAPES:
        g = torch.Generator(device=dev).manual_seed(E + M)
        a32 = torch.randn((E, M, K), generator=g, device=dev)
        w32 = torch.randn((E, K, N), generator=g, device=dev) * K ** -0.5
        dc32 = torch.randn((E, M, N), generator=g, device=dev)
        for dt, tol in ((torch.float32, F32_REL_TOL),
                        (torch.bfloat16, BF16_TOL)):
            a, w, dc = (x.to(dt, copy=True).requires_grad_(x is not dc32)
                        for x in (a32, w32, dc32))
            n0 = ops.launches
            out = ops.GroupedGemm.apply(a, w)
            da, dw = torch.autograd.grad(out, (a, w), dc)
            n = ops.launches - n0
            errs = []
            for got, want in ((da, ref.grouped_gemm_ref(
                    dc, w.detach().transpose(1, 2))), (dw, ref.grouped_gemm_ref(
                    a.detach().transpose(1, 2), dc))):
                errs.append(float((got.float() - want.float()).abs().max()
                                  / want.float().abs().max()))
            check(max(errs) <= tol and n == 3, f"grouped GEMM backward "
                  f"{name} ({E}, {M}, {K}) x ({E}, {K}, {N}) {dt}: dA, dW "
                  f"relative max error {[f'{e:.3g}' for e in errs]} (tol "
                  f"{tol}); {n} launches for the forward and the two "
                  "products (want 3)")
            del a, w, dc, out, da, dw
        a, w, dc = (x.to(torch.bfloat16) for x in (a32, w32, dc32))
        del a32, w32, dc32
        wt, at = w.transpose(1, 2).contiguous(), a.transpose(1, 2).contiguous()
        entry = {}
        for prod, x, y, xt, yt in (("dA", dc, wt, dc, w.transpose(1, 2)),
                                   ("dW", at, dc, a.transpose(1, 2), dc)):
            Mx, Kx, Nx = x.shape[1], x.shape[2], y.shape[2]
            n_bytes = 2 * E * (Mx * Kx + Kx * Nx + Mx * Nx)
            n_ops = 2 * E * Mx * Kx * Nx
            b_ms, b_by = bound_ms(n_bytes, n_ops, torch.bfloat16)
            ms = time_ms(lambda: ops.grouped_gemm(x, y), 10)
            plain = time_ms(lambda: ref.grouped_gemm_ref(xt, yt), 3, 1)
            lib = time_ms(lambda: torch.bmm(xt, yt), 10)
            entry[prod] = {"shape": f"({E}, {Mx}, {Kx}) x ({E}, {Kx}, {Nx})",
                           "ms": ms, "plain_ms": plain, "bound_ms": b_ms,
                           "bound_by": b_by, "library_ms": lib}
            print(f"grouped GEMM backward {name} {prod} = "
                  f"{'dC·Wᵀ' if prod == 'dA' else 'Aᵀ·dC'} {entry[prod]['shape']}"
                  f" bf16: kernel {ms:.4f} ms ({n_ops / ms / 1e9:.2f} "
                  f"TFLOP/s), plain {plain:.4f} ms, torch.bmm {lib:.4f} ms, "
                  f"bound {b_ms:.4f} ms ({b_by})")
        for what, t in (("Wᵀ", w), ("Aᵀ", a)):
            ms = time_ms(lambda: t.transpose(1, 2).contiguous(), 10)
            n_bytes = 2 * 2 * t.numel()
            entry[f"copy {what}"] = {"ms": ms, "bytes": n_bytes}
            print(f"grouped GEMM backward {name}: the contiguous copy of "
                  f"{what} {tuple(t.shape)} bf16, {n_bytes / 1e6:.1f} MB read "
                  f"and written: {ms:.4f} ms "
                  f"({n_bytes / ms / 1e6:.1f} GB/s)")
        res[name] = entry
        del a, w, dc, wt, at
        torch.cuda.empty_cache()
    return res


# -------------------------------------------------------------- tiled GEMM
def gemm_phase(dev) -> dict:
    """The paper's GEMM first at the shapes the hbb path gives it: chunks
    A[:S_f] (a view) of a 1024² f32 A times a 1024² B at each shape's plan
    (``ops.plan``: tile and split of K), S_f over FPGA_CHUNK_SWEEP; the
    line's numbers are those of S_f = 256. Then the scaling study's 4096³ in
    f32 (the contract's type, CUDA cores) and bf16 (tensor cores) at their
    plan, with Table 2 on the card: the bn ("buffered columns") sweep at
    bm = 64, bk = 32 with each shape's shared memory, launched as given. f32
    within 1e-5 and bf16 within 2e-2 of the largest value, against the plain
    version; two calls at a plan bit-equal. Each planned shape's kernels
    also by device time (one profiled call), apart from the call's host
    cost that the CUDA-event time includes."""
    from repro_torch.configs.gemm_paper import FPGA_CHUNK_SWEEP, GEMM_N_MAIN
    from repro_torch.kernels.gemm import ops, ref
    tols = {torch.float32: 1e-5, torch.bfloat16: 2e-2}

    def measure(a, b, dt, label, iters):
        want = ref.gemm_ref(a, b)
        out = ops.gemm(a, b)
        same = torch.equal(out, ops.gemm(a, b))
        e = float((out.float() - want.float()).abs().max()
                  / want.float().abs().max())
        (M, K), N = a.shape, b.shape[1]
        pl = ops.plan(M, N, K, dt)
        check(e <= tols[dt] and same, f"gemm {label} {dt} plan (bm, bn, bk, "
              f"splits) {pl}: relative max error {e:.3g} (tol {tols[dt]}), "
              f"two calls bit-equal {same}")
        n_ops = 2 * M * N * K
        b_ms, b_by = bound_ms((M * K + K * N + M * N) * a.element_size(),
                              n_ops, dt)
        ms = time_ms(lambda: ops.gemm(a, b), iters)
        plain = time_ms(lambda: ref.gemm_ref(a, b), iters)
        lib = time_ms(lambda: torch.matmul(a, b), iters)
        dev_ms = sum(t for t, _ in kernels_ms(lambda: ops.gemm(a, b))[0]
                     .values())
        print(f"gemm {label} {dt} plan {pl}: kernel {ms:.4f} ms "
              f"({n_ops / ms / 1e9:.2f} TFLOP/s; device {dev_ms:.4f} ms), "
              f"plain {plain:.4f} ms, torch.matmul {lib:.4f} ms, "
              f"kernel/torch.matmul {ms / lib:.2f}x, bound {b_ms:.4f} ms "
              f"({b_by}), kernel/bound {ms / b_ms:.1f}x")
        return want, dict(max_abs_err=e, ms=ms, plain_ms=plain,
                          bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                          device_ms=dev_ms, plan=list(pl))

    n = GEMM_N_MAIN
    g = torch.Generator(device=dev).manual_seed(0)
    A = torch.randn((n, n), generator=g, device=dev)
    B = torch.randn((n, n), generator=g, device=dev)
    chunks = []
    for sf in FPGA_CHUNK_SWEEP:
        _, r = measure(A[:sf], B, torch.float32, f"chunk S_f={sf}x{n}x{n}",
                       200)
        chunks.append({"S_f": sf, **r})
    main = chunks[-1]
    del A, B

    n = 4096
    g = torch.Generator(device=dev).manual_seed(0)
    a32 = torch.randn((n, n), generator=g, device=dev)
    b32 = torch.randn((n, n), generator=g, device=dev)
    n_ops = 2 * n ** 3
    res = {}
    for dt in (torch.float32, torch.bfloat16):
        a, b = a32.to(dt), b32.to(dt)
        want, r = measure(a, b, dt, f"{n}³", 10)
        sweep = []
        for bn in (32, 64, 128, 256):
            blk_bn = dict(bm=64, bn=bn, bk=32)
            es = float((ops.gemm(a, b, **blk_bn).float() - want.float()).abs()
                       .max() / want.float().abs().max())
            check(es <= tols[dt], f"gemm {n}² {dt} bn={bn}: relative max "
                  f"error {es:.3g} (tol {tols[dt]})")
            t = time_ms(lambda: ops.gemm(a, b, **blk_bn), 5)
            smem = ops.smem_bytes(64, bn, 32, a.element_size())
            sweep.append({"bn": bn, "smem_bytes": smem, "ms": t})
            print(f"  Table 2 {dt} bm=64 bn={bn:3d} bk=32: shared memory "
                  f"{smem} B ({100 * smem / ops.SMEM_LIMIT:.1f} % of "
                  f"{ops.SMEM_LIMIT}), {t:.4f} ms, "
                  f"{n_ops / t / 1e9:.2f} TFLOP/s")
        res[str(dt).removeprefix("torch.")] = dict(r, table2=sweep)
        del a, b, want
    del a32, b32
    torch.cuda.empty_cache()
    return {"name": "gemm", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/gemm.cu",
            "replaces": "src/repro/kernels/gemm/gemm.py:39",
            "paths": ["hbb"], "tol": tols[torch.float32],
            **{k: main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms")},
            "max_abs_err": max(c["max_abs_err"] for c in chunks),
            "chunks": chunks, "n4096": res,
            "check": "relative max error against gemm_ref: f32 (tol 1e-5) "
                     "on the hbb path's chunks A[:S_f] of a 1024² A, S_f "
                     "8..256, and at 4096² in f32 and bf16 (tol 2e-2), each "
                     "at its plan (two calls bit-equal) and at every bn of "
                     "the Table 2 sweep as given; "
                     "ms, plain_ms, bound_ms and library_ms (torch.matmul, "
                     "allow_tf32 off) are the path's S_f = 256 chunk, f32; "
                     "chunks and n4096 hold the rest"}


# ------------------------------------------------------------ SSD intra-chunk
def ssd_case(dev, G: int, Q: int, P: int, N: int, H: int = 24):
    """x, cs, B, C of G chunk rows in ssd_scan's layout (heads second, B and
    C shared by the heads: stride 0), made on the card from seed Q + P."""
    g = torch.Generator(device=dev).manual_seed(Q + P)
    x = torch.randn((G, Q, H, P), generator=g, device=dev)
    cs = torch.cumsum(-F.softplus(torch.randn((G, Q, H), generator=g,
                                              device=dev)), dim=1)
    Bm = torch.randn((G, Q, N), generator=g, device=dev)
    Cm = torch.randn((G, Q, N), generator=g, device=dev)
    return (x.permute(0, 2, 1, 3), cs.permute(0, 2, 1),
            Bm[:, None].expand(-1, H, -1, -1),
            Cm[:, None].expand(-1, H, -1, -1))


# mamba2-130m's intra-chunk shapes (G chunk rows, Q, P, N): a 1827-2048
# token prompt (8 rows of 256), the exact-length Q = 97, P 72, N 40, which
# only the CUDA-core route takes, and a training step's 8 x 2048 tokens
SSD_TRAIN = (64, 256, 64, 128)
SSD_SHAPES = ((8, 256, 64, 128), (1, 97, 64, 128), (8, 256, 72, 40),
              SSD_TRAIN)


def ssd_work(G: int, Q: int, P: int, N: int, H: int = 24) -> dict:
    """What one call must move and compute: the bytes (x, y, st, B, C, cs,
    each once), the f32 operations with the scores formed once per chunk
    row and shared by the heads, and those of the per-head count the
    CUDA-core kernel does."""
    pairs = Q * (Q + 1) // 2
    return {"bytes": 4 * (2 * G * Q * H * P + G * Q * H + 2 * G * Q * N
                          + G * H * N * P),
            "shared_ops": G * (2 * N * pairs + H * (2 * P * pairs
                                                    + 2 * Q * N * P)),
            "per_head_ops": G * H * (2 * (N + P) * pairs + 2 * Q * N * P)}


def ssd_phase(dev) -> dict:
    """The SSD intra-chunk at SSD_SHAPES, each on the route ssd_route gives
    it (tensor cores for P 64, N 128; CUDA cores for P 72, N 40): relative
    max error of y and st within 1e-4 of the plain version (f32, other sum
    order and exp), two calls bit-equal, one launch a call. Times: device
    ms (torch.profiler, 20 calls) beside the wrapper's event ms. The bound
    is the larger of the bytes at 3.35 TB/s and the shared-score operations
    as three TF32 tensor-core products each at 495 TFLOP/s."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.ssd import ops, ref
    regs = _build.ptxas_stats("ssd").get("ssd_mma", {})
    check(regs.get("spill_stores") == 0 and regs.get("spill_loads") == 0,
          f"ssd_mma: no spills (ptxas {regs})")
    err, shapes = 0.0, []
    for G, Q, P, N in SSD_SHAPES:
        args = ssd_case(dev, G, Q, P, N)
        route = ops.route_of(args[0], args[2], args[3])
        check(route == ("mma" if P <= 64 else "f32"), f"ssd intra-chunk "
              f"P={P} N={N} takes the {route} route")
        y, st = ops.intra_chunk(*args)
        y2, st2 = ops.intra_chunk(*args)
        same = torch.equal(y, y2) and torch.equal(st, st2)
        yr, str_ = ref.ssd_intra_chunk_ref(*args)
        e = max(float((y - yr).abs().max() / yr.abs().max()),
                float((st - str_).abs().max() / str_.abs().max()))
        err = max(err, e)
        check(e <= 1e-4 and same, f"ssd intra-chunk ({route}) G={G}x24 "
              f"Q={Q} P={P} N={N}: relative max error of y and st {e:.3g} "
              f"(tol 1e-4), two calls bit-equal {same}")
        by_name, counted = kernels_ms(lambda: ops.intra_chunk(*args), 20)
        check(len(by_name) == 1 and all(n == 1 and "ssd_" in k for k, (
            _, n) in by_name.items()) and counted["ssd_intra_chunk"] == 1,
              f"ssd intra-chunk G={G} Q={Q}: one launch a call, nothing "
              f"else on the card ({ {k[:40]: n for k, (_, n) in by_name.items()} }"
              f"; counted {counted['ssd_intra_chunk']})")
        ms = sum(t for t, _ in by_name.values())
        event = time_ms(lambda: ops.intra_chunk(*args), 20)
        plain = time_ms(lambda: ref.ssd_intra_chunk_ref(*args), 5)
        w = ssd_work(G, Q, P, N)
        t_bytes = 1e3 * w["bytes"] / HBM_BYTES_PER_S
        t_ops = 1e3 * 3 * w["shared_ops"] / PEAK_OPS_PER_S["tf32"]
        per_head = 1e3 * w["per_head_ops"] / PEAK_OPS_PER_S[torch.float32]
        b_ms = max(t_bytes, t_ops)
        b_by = "bytes" if t_bytes >= t_ops else "operations"
        plan = ops.plan_of(args[0], args[2], args[3]) if route == "mma" \
            else None
        print(f"ssd intra-chunk G={G}x24 Q={Q} P={P} N={N}: route {route}"
              f"{f' plan {tuple(plan)}' if plan else ''}: device {ms:.4f} "
              f"ms ({w['shared_ops'] / ms / 1e9:.1f} TFLOP/s of shared-"
              f"score work), event {event:.4f} ms a call, plain {plain:.4f}"
              f" ms; bound {b_ms:.4f} ms ({b_by}: bytes {t_bytes:.4f} ms "
              f"for {w['bytes'] / 1e6:.2f} MB, shared-score operations "
              f"{w['shared_ops'] / 1e9:.3f} GFLOP as 3xTF32 {t_ops:.4f} ms);"
              f" the per-head f32 CUDA-core count "
              f"{w['per_head_ops'] / 1e9:.3f} GFLOP would take "
              f"{per_head:.4f} ms")
        shapes.append({"G": G, "Q": Q, "P": P, "N": N, "route": route,
                       "plan": plan, "device_ms": ms, "event_ms": event,
                       "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
                       "max_err": e, "bit_equal": same})
    # the backward (SsdIntraChunk: the plain version recomputed under
    # autograd and differentiated) at the training shape, B and C leaves
    # of one head expanded with stride 0 as ssd_scan passes them
    x, cs, Bm, Cm = ssd_case(dev, *SSD_TRAIN)
    ins = [t.detach().requires_grad_() for t in (x, cs, Bm[:, :1], Cm[:, :1])]
    y, st = ref.ssd_intra_chunk_ref(*ins[:2], *(t.expand_as(Bm)
                                                for t in ins[2:]))
    dy, dst = torch.randn_like(y), torch.randn_like(st)
    del y, st

    def plain_bwd():
        with torch.enable_grad():
            outs = ref.ssd_intra_chunk_ref(*ins[:2], *(t.expand_as(Bm)
                                                       for t in ins[2:]))
            return torch.autograd.grad(outs, ins, (dy, dst))

    bwd = time_ms(plain_bwd, 5, 1)
    G, Q, P, N = SSD_TRAIN
    train = next(x for x in shapes if (x["G"], x["Q"], x["P"], x["N"])
                 == SSD_TRAIN)
    train["plain_backward_ms"] = bwd
    print(f"ssd intra-chunk G={G}x24 Q={Q} P={P} N={N} (a mamba2 training "
          f"layer): forward device {train['device_ms']:.4f} ms, the plain "
          f"backward (recompute + autograd) {bwd:.4f} ms, "
          f"{bwd / train['device_ms']:.1f}x the forward")
    del x, cs, Bm, Cm, ins, dy, dst
    torch.cuda.empty_cache()
    main = shapes[0]
    return {"name": "ssd_intra_chunk", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssd.cu",
            "replaces": "src/repro/kernels/ssd/ssd.py:46",
            "paths": ["mamba2-130m", "train-ssm", "variant mamba2-postnorm",
                      "train-mamba2-postnorm"],
            "max_abs_err": err, "tol": 1e-4, "ms": main["device_ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": None,
            "ssd": shapes,
            "check": "relative max error of y and st against "
                     "ssd_intra_chunk_ref, f32, 24 heads, stride-0 B/C: "
                     "tensor-core route (ssd_mma) at G=8 Q=256 P=64 N=128 "
                     "and G=1 Q=97, CUDA-core route (ssd_intra) at G=8 "
                     "Q=256 P=72 N=40, and the training shape G=64 Q=256 "
                     "(its plain backward timed); two calls bit-equal on "
                     "both; ms is the first's device time; library: none, "
                     "no single PyTorch call computes it"}


# ------------------------------------------------- Mamba-1 selective scan
# jamba-v0.1-52b's prefill scan (B rows, S steps, C = d_inner, N = d_state):
# one exact-length row of the workload's longest prompt, and eight
SCAN_SHAPES = ((1, 2000, 8192, 16), (8, 2000, 8192, 16))
# exps an SM retires a clock on its special-function units (compute
# capability 9.0; CUDA C Programming Guide, arithmetic instruction
# throughput: exp2, log2, reciprocal, sine and cosine)
SFU_PER_CLOCK = 16


def scan_work(B: int, S: int, C: int, N: int, save: bool = False) -> dict:
    """What one forward call must move and compute: x, dt and y at 4 B per
    (t, c), Bm and Cm at 4 B per (t, n), A, h0 and h_last once, and with
    ``save`` the state entering each checkpoint interval (``ops.TS``
    steps); per (t, c, n) dt·A, the decay's FMA, (dt·x)·B and y's FMA (6
    f32 operations) and one exp, per (t, c) dt·x."""
    from repro_torch.kernels.selective_scan import ops
    K = -(-S // ops.TS) if save else 0
    return {"bytes": 4 * (3 * B * S * C + 2 * B * S * N + C * N
                          + (2 + K) * B * C * N),
            "ops": B * S * C * (6 * N + 1), "exps": B * S * C * N}


def scan_bwd_work(B: int, S: int, C: int, N: int) -> dict:
    """What one backward call must move and compute. Bytes: x, dt, dy read
    and dx, ddt written at 4 B per (t, c); Bm, Cm read and dB, dC written
    at 4 B per (t, n); the saved states hs (one (C, N) state per ``ops.TS``
    steps), dh_last read and dh0 written per (c, n) and row; A read and dA
    written once. Per (t, c, n): the recompute of the state (dt·A, (dt·x)·B,
    the decay's FMA: 3 f32 operations) and its exp, kept for the reverse
    step (g += C·dy, h·dy, (dt·x)·g, Σ B·g, a·h_{t-1}·g, dA's FMA, Σ A·w,
    g·a: 9), and the sums of dB and dC over the channels (2): 14 operations
    and one exp; per (t, c) dx, ddt and dt·x (4). The kernel takes one exp
    a (t, c, n) where its sub-tile is the whole interval (N up to 16);
    above, it recomputes sub-tiles' entering states, which this count
    leaves out."""
    from repro_torch.kernels.selective_scan import ops
    K = -(-S // ops.TS)
    return {"bytes": 4 * (5 * B * S * C + 4 * B * S * N + B * K * C * N
                          + 2 * B * C * N + 2 * C * N),
            "ops": B * S * C * (14 * N + 4), "exps": B * S * C * N}


@functools.cache
def max_sm_clock_mhz() -> float:
    """The card's maximum SM clock, as ``nvidia-smi --query-gpu=
    clocks.max.sm`` gives it (read once)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True)
    return float(out.stdout.split()[0])


def scan_bound(w: dict) -> tuple[float, str, str]:
    """The least time of a scan call's work ``w``: the largest of its bytes
    at 3.35 TB/s, its f32 operations at 67 TFLOP/s and its exps at
    ``SFU_PER_CLOCK`` a clock on every SM at the maximum SM clock → (ms,
    "bytes" or "operations" as the kernels line says it, and which of
    bytes, f32 operations or exps set it)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    t = {"bytes": w["bytes"] / HBM_BYTES_PER_S,
         "f32 operations": w["ops"] / PEAK_OPS_PER_S[torch.float32],
         "exps": w["exps"] / (SFU_PER_CLOCK * sms * max_sm_clock_mhz()
                              * 1e6)}
    by = max(t, key=t.get)
    return 1e3 * t[by], "bytes" if by == "bytes" else "operations", by


def scan_bound_text(w: dict) -> str:
    """The printed reading of :func:`scan_bound`."""
    ms, _, by = scan_bound(w)
    return (f"bound {ms:.4f} ms (set by {by}: {w['bytes'] / 1e6:.1f} MB, "
            f"{w['ops'] / 1e9:.2f} GFLOP f32, {w['exps'] / 1e9:.3f} G exp "
            f"at {SFU_PER_CLOCK} a clock an SM, max SM clock "
            f"{max_sm_clock_mhz():.0f} MHz)")


def selective_scan_phase(dev) -> dict:
    """The Mamba-1 selective scan at SCAN_SHAPES (x, Bm, Cm and a nonzero
    h0 unit normal, dt a softplus, A = -exp of N(0, 1/4)): y and h_last
    each within 1e-4 of the plain version's largest value (f32: the kernel
    walks the steps in order, the plain version combines them by a
    log-step scan within JAX's chunks of 256), two calls bit-equal, one
    launch a call; the training forward (the instance that also saves the
    state entering each ``ops.TS``-step tile) gives the same y and h_last
    bit for bit, h0 as its first state and the rest within 1e-4 of the
    plain version's tile states; every instance built without spills and
    bringing its inputs in by cp.async; event ms of kernel and plain
    version beside the bound (:func:`scan_bound`: bytes at 3.35 TB/s, f32
    operations at 67 TFLOP/s, exps on the special-function units). No
    PyTorch call computes a selective scan: library none."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.selective_scan import ops, ref
    regs = _build.ptxas_stats("selective_scan")
    kinds = Counter(k.split("<")[0] for k in regs)
    check(kinds == {"selective_scan_kernel": 16,
                    "selective_scan_bwd_kernel": 8, "sum_parts_kernel": 1}
          and all(r.get("spill_stores") == 0 and r.get("spill_loads") == 0
                  for r in regs.values()),
          f"selective_scan: 8 forward instances (N = 8..64) each for "
          f"serving and for training, 8 backward instances and the sum of "
          f"the partials, no spills (ptxas {regs})")
    copies = {k: c.get("LDGSTS", 0)
              for k, c in _build.sass_counts("selective_scan").items()
              if k.startswith("selective_scan")}
    check(len(copies) == 24 and all(copies.values()),
          f"selective_scan: every forward and backward instance brings its "
          f"inputs in by cp.async (LDGSTS lines in the SASS: {copies})")
    err, shapes = 0.0, []
    for B, S, C, N in SCAN_SHAPES:
        g = torch.Generator(device=dev).manual_seed(B)

        def t(*shape):
            return torch.randn(shape, generator=g, device=dev)

        x = t(B, S, C)
        dt = F.softplus(t(B, S, C) - 1.0)
        A = -torch.exp(0.5 * t(C, N))
        args = (x, dt, A, t(B, S, N), t(B, S, N), t(B, C, N))
        n0 = ops.launches
        y, h = ops.selective_scan(*args, 256)
        one = ops.launches == n0 + 1
        y2, h2 = ops.selective_scan(*args, 256)
        same = torch.equal(y, y2) and torch.equal(h, h2)
        yr, hr = ref.selective_scan_ref(*args, 256)
        e_abs = max(float((y - yr).abs().max()), float((h - hr).abs().max()))
        e = max(float((y - yr).abs().max() / yr.abs().max()),
                float((h - hr).abs().max() / hr.abs().max()))
        err = max(err, e_abs)
        check(e <= 1e-4 and same and one, f"selective scan B={B} S={S} "
              f"C={C} N={N}: relative max error of y and h_last {e:.3g} (tol"
              f" 1e-4), two calls bit-equal {same}, one launch {one}")
        y2, h2, hs = ops.scan_forward(*args, 256, save=True)
        _, _, hs_r = ref.selective_scan_ref(*args, 256, tile=ref.TILE)
        e_s = float((hs - hs_r).abs().max() / hs_r.abs().max())
        same_s = torch.equal(y, y2) and torch.equal(h, h2) and \
            torch.equal(hs[:, 0], args[5])
        check(e_s <= 1e-4 and same_s, f"selective scan B={B} S={S} C={C} "
              f"N={N}, the training forward: y, h_last and h0 bit-equal to "
              f"the serving forward's {same_s}, tile states within {e_s:.3g}"
              f" of the plain version's largest (tol 1e-4)")
        del y, h, y2, h2, yr, hr, hs, hs_r
        torch.cuda.empty_cache()
        ms = time_ms(lambda: ops.selective_scan(*args, 256), 10)
        plain = time_ms(lambda: ref.selective_scan_ref(*args, 256), 2, 1)
        w = scan_work(B, S, C, N)
        b_ms, b_by, _ = scan_bound(w)
        print(f"selective scan B={B} S={S} C={C} N={N}: kernel {ms:.4f} ms "
              f"({w['bytes'] / ms / 1e6:.1f} GB/s), plain {plain:.4f} ms, "
              f"{scan_bound_text(w)}, kernel/bound {ms / b_ms:.1f}x; "
              f"library none")
        shapes.append({"B": B, "S": S, "C": C, "N": N, "ms": ms,
                       "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
                       "max_abs_err": e_abs, "rel_err": e, "bit_equal": same})
        del x, dt, A, args
        torch.cuda.empty_cache()
    main = shapes[0]
    return {"name": "selective_scan", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/selective_scan.cu",
            "replaces": "src/repro/models/mamba.py:295 (no TPU kernel: "
                        "mamba1_mixer's associative_scan in XLA)",
            "paths": ["jamba-v0.1-52b", "train-hybrid", "jamba-spec",
                      "variant jamba-postnorm", "train-jamba-postnorm"],
            "max_abs_err": err, "tol": 1e-4, "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": None,
            "scan": shapes,
            "check": "y and h_last against selective_scan_ref, f32, each "
                     "within 1e-4 of the reference's largest value, nonzero "
                     "h0, B=1 and B=8 at S=2000 C=8192 N=16; two calls "
                     "bit-equal; ms is B=1's event time; library: none, no "
                     "PyTorch call computes a selective scan"}


SCAN_TRAIN = (2, 2048, 8192, 16)      # jamba's Mamba-1 layer at B 2 x 2048


def scan_backward_phase(dev) -> dict:
    """The selective scan's backward at jamba's training layer (SCAN_TRAIN;
    inputs as :func:`selective_scan_phase`'s, a nonzero h0 and a nonzero
    dh_last): the training forward's saved states, then dx, ddt, dA, dB, dC
    and dh0 of the backward kernel each within 1e-4 of its largest value of
    ``selective_scan_bwd_ref`` on the same states and within 1e-3 of
    autograd through ``selective_scan_ref`` (JAX's chunk 256; one batch row
    at a time, dA summed over them), two calls bit-equal, and per call one
    reverse walk and one sum of the partials in the profile (one count on
    the wrapper); event ms of the backward and of its plain version beside
    the bound (:func:`scan_bwd_work`), and of the training forward beside
    the serving one. No PyTorch call computes a selective scan's backward:
    library none."""
    from repro_torch.kernels.selective_scan import ops, ref
    B, S, C, N = SCAN_TRAIN
    g = torch.Generator(device=dev).manual_seed(S + N)

    def t(*shape):
        return torch.randn(shape, generator=g, device=dev)

    x = t(B, S, C)
    dt = F.softplus(t(B, S, C) - 1.0)
    A = -torch.exp(0.5 * t(C, N))
    ins = (x, dt, A, t(B, S, N), t(B, S, N), t(B, C, N))
    dy, dh = t(B, S, C), t(B, C, N)
    _, _, hs = ops.scan_forward(*ins, 256, save=True)
    names = ("dx", "ddt", "dA", "dB", "dC", "dh0")
    got = ops.selective_scan_bwd(*ins[:5], hs, dy, dh)
    again = ops.selective_scan_bwd(*ins[:5], hs, dy, dh)
    bit = all(torch.equal(a, b) for a, b in zip(got, again))
    del again
    want = ref.selective_scan_bwd_ref(*ins[:5], hs, dy, dh)
    e_ref = {n: float((a - b).abs().max() / b.abs().max())
             for n, a, b in zip(names, got, want)}
    e_abs = max(float((a - b).abs().max()) for a, b in zip(got, want))
    del want
    torch.cuda.empty_cache()
    parts = []
    for b in range(B):
        leaves = [v.clone().requires_grad_() for v in (
            x[b:b + 1], dt[b:b + 1], A, ins[3][b:b + 1], ins[4][b:b + 1],
            ins[5][b:b + 1])]
        parts.append(torch.autograd.grad(
            ref.selective_scan_ref(*leaves, 256), leaves,
            (dy[b:b + 1], dh[b:b + 1])))
        del leaves
        torch.cuda.empty_cache()
    oracle = [torch.cat([p[i] for p in parts]) for i in (0, 1)] + \
        [parts[0][2] + parts[1][2]] + \
        [torch.cat([p[i] for p in parts]) for i in (3, 4, 5)]
    e_auto = {n: float((a - b).abs().max() / b.abs().max())
              for n, a, b in zip(names, got, oracle)}
    del parts, oracle
    torch.cuda.empty_cache()
    by_name, counted = kernels_ms(lambda: ops.selective_scan_bwd(
        *ins[:5], hs, dy, dh))
    walk = [v for k, v in by_name.items() if "selective_scan_bwd" in k]
    sums = [v for k, v in by_name.items() if "sum_parts" in k]
    launches_ok = len(walk) == 1 and walk[0][1] == 1 and len(sums) == 1 \
        and sums[0][1] == 1 and counted["selective_scan_bwd"] == 1
    check(max(e_ref.values()) <= 1e-4 and max(e_auto.values()) <= 1e-3 and
          bit and launches_ok,
          f"selective scan backward B={B} S={S} C={C} N={N}: relative max "
          f"error against selective_scan_bwd_ref "
          f"{ {k: f'{v:.3g}' for k, v in e_ref.items()} } (tol 1e-4), "
          f"against autograd through selective_scan_ref "
          f"{ {k: f'{v:.3g}' for k, v in e_auto.items()} } (tol 1e-3); two "
          f"calls bit-equal {bit}; a call's kernels {by_name} and wrapper "
          f"count {counted['selective_scan_bwd']} (want one reverse walk, "
          "one sum and one count)")
    ms = time_ms(lambda: ops.selective_scan_bwd(*ins[:5], hs, dy, dh), 10)
    plain = time_ms(lambda: ref.selective_scan_bwd_ref(*ins[:5], hs, dy, dh),
                    1, 1)
    fwd = time_ms(lambda: ops.scan_forward(*ins, 256), 10)
    fwd_save = time_ms(lambda: ops.scan_forward(*ins, 256, save=True), 10)
    w = scan_bwd_work(B, S, C, N)
    b_ms, b_by, _ = scan_bound(w)
    w_save = scan_work(B, S, C, N, save=True)
    save_bound = scan_bound(w_save)[0]
    device_ms = {k: v[0] for k, v in by_name.items()}
    print(f"selective scan backward B={B} S={S} C={C} N={N}: kernel {ms:.4f}"
          f" ms ({w['bytes'] / ms / 1e6:.1f} GB/s; device ms "
          f"{ {k: round(v, 4) for k, v in device_ms.items()} }), plain "
          f"{plain:.4f} ms, {scan_bound_text(w)}, kernel/bound "
          f"{ms / b_ms:.1f}x; forward {fwd:.4f} ms serving, {fwd_save:.4f} "
          f"ms saving the tile states (every {ops.TS} steps; "
          f"{scan_bound_text(w_save)}, kernel/bound "
          f"{fwd_save / save_bound:.1f}x); library none")
    del x, dt, A, ins, dy, dh, hs, got
    torch.cuda.empty_cache()
    return {"name": "selective_scan_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/selective_scan.cu",
            "replaces": "src/repro/models/mamba.py:295 (no TPU kernel: JAX "
                        "differentiates mamba1_mixer's associative_scan in "
                        "XLA)",
            "paths": ["train-hybrid", "train-jamba-postnorm"],
            "max_abs_err": e_abs, "tol": 1e-4, "ms": ms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "scan_bwd": {"err_ref": e_ref, "err_autograd": e_auto,
                         "bit_equal": bit, "device_ms": device_ms,
                         "fwd_ms": fwd, "fwd_save_ms": fwd_save,
                         "fwd_save_bound_ms": save_bound},
            "check": f"dx, ddt, dA, dB, dC, dh0 against "
                     f"selective_scan_bwd_ref on the kernel's saved states "
                     f"(tol 1e-4) and autograd through selective_scan_ref "
                     f"(tol 1e-3), each relative to its largest value, f32, "
                     f"B={B} S={S} C={C} N={N}, nonzero h0 and dh_last; two "
                     f"calls bit-equal; library: none, no PyTorch call "
                     f"computes a selective scan's backward"}


# ----------------------------------------------------- the paper's Fig. 5
def hbb_phase(dev, entries) -> None:
    """HBB ``parallel_for`` over the rows of C = A @ B (f32): the card's
    GEMM kernel as the accelerator class (one token), host threads running
    the per-row numpy path as the core class. Fig. 5 at 1024² — configs
    (ncc, 0), (0, 1), (ncc, 1) over S_f in FPGA_CHUNK_SWEEP, every result
    against the plain product (max error within 1e-5 of the largest value)
    — then offload-only
    against heterogeneous at 4096². The kernel's launch count is read from
    the 1024² sweep. Also the accelerator's per-chunk host overhead: its
    mean service time in the offload-only runs against the kernel call
    alone and its device time (the gemm phase's at the same chunk shape)."""
    import os
    from repro_torch.configs.gemm_paper import (FPGA_CHUNK_SWEEP,
                                                GEMM_N_MAIN, GEMM_N_SCALING)
    from repro_torch.examples import hetero_gemm
    from repro_torch.kernels.gemm import ops
    cores = os.cpu_count() or 2
    ncc = max(1, cores - 1)
    print(f"Fig. 5 on the card: {ncc} core tokens (the host has {cores} "
          "cores; one drives the card), 1 accelerator token, f0 = 8")
    ops.launches = 0
    rows = hetero_gemm.fig5(GEMM_N_MAIN, ncc, FPGA_CHUNK_SWEEP, device=dev)
    n = ops.launches
    _add_launches(entries, {"gemm": n}, "hbb", ["gemm"])
    gemm = next(e for e in entries if e["name"] == "gemm")
    check(all(r.ok for r in rows), f"Fig. 5 at {GEMM_N_MAIN}²: every "
          "config's C equals the plain product (relative max error ≤ 1e-5)")
    t_off, t_het, red = hetero_gemm.reduction(rows)
    print(f"Fig. 5 at {GEMM_N_MAIN}²: offload-only best {t_off:.4f} s, "
          f"heterogeneous best {t_het:.4f} s → reduction {100 * red:.1f} % "
          "(paper §6: 25–50 %)")
    kernel_ms = {c["S_f"]: (c["ms"], c["device_ms"]) for c in gemm["chunks"]}
    for r in rows:
        if r.ncc:
            continue
        recs = [x for x in r.report.records if x.resource == "FC0"]
        service = sum(x.t_end - x.t_start for x in recs) / len(recs) * 1e3
        k, d = kernel_ms[r.chunk]
        pl = ops.plan(r.chunk, GEMM_N_MAIN, GEMM_N_MAIN, torch.float32)
        print(f"  S_f={r.chunk:4d} plan {pl}: accelerator chunk service "
              f"{service:.4f} ms, kernel call alone {k:.4f} ms (device "
              f"{d:.4f} ms) → host overhead {service - k:.4f} ms per chunk "
              f"beyond the call, {service - d:.4f} ms beyond the device "
              f"({len(recs)} chunks)")
    rows = hetero_gemm.fig5(GEMM_N_SCALING, ncc, FPGA_CHUNK_SWEEP,
                            device=dev, configs=[(0, 1), (ncc, 1)])
    check(all(r.ok for r in rows), f"Fig. 5 at {GEMM_N_SCALING}²: every "
          "config's C equals the plain product (relative max error ≤ 1e-5)")
    t_off, t_het, red = hetero_gemm.reduction(rows)
    print(f"scaling at {GEMM_N_SCALING}²: offload-only best {t_off:.4f} s, "
          f"heterogeneous best {t_het:.4f} s → reduction {100 * red:.1f} %")
    torch.cuda.empty_cache()


# ------------------------------------------------------- full-width serving
def _counters() -> dict:
    """Kernel name → (wrapper module, name of its launch count)."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.gemm import ops as gemm_ops
    from repro_torch.kernels.grouped_gemm import ops as gg_ops
    from repro_torch.kernels.paged_attention import ops as paged_ops
    from repro_torch.kernels.selective_scan import ops as scan_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    return {"paged_attention_gqa": (paged_ops, "launches"),
            "flash_attention_fwd": (flash_ops, "launches"),
            "flash_attention_bwd": (flash_ops, "bwd_launches"),
            "flash_attention_fwd_lse": (flash_ops, "lse_launches"),
            "paged_attention_mla": (paged_ops, "mla_launches"),
            "grouped_gemm": (gg_ops, "launches"),
            "gemm": (gemm_ops, "launches"),
            "ssd_intra_chunk": (ssd_ops, "launches"),
            "selective_scan": (scan_ops, "launches"),
            "selective_scan_bwd": (scan_ops, "bwd_launches")}


def _zero_counts() -> dict:
    """Every wrapper's launch count set to 0 → ``_counters()``."""
    counters = _counters()
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    return counters


def serve_run(eng, cfg, lens, prompts, max_new: int):
    """Serve the workload once through ``eng`` with every wrapper's launch
    count set to 0 just before and read just after → (requests, launch
    counts). Prints the wall time, prefill and decode seconds and rates
    (decode over the quanta the tracker records: every eager quantum, and
    with graphs every replay; a quantum that captured is not recorded, as
    the JAX engine does not time one that compiled), the graph captures
    and their seconds, the width buckets and peak memory. Checks that the
    page pool is whole after the run."""
    from repro_torch.serve.engine import Request
    reqs = [Request(rid=i, prompt=p, max_new=max_new)
            for i, p in enumerate(prompts)]
    torch.cuda.reset_peak_memory_stats()
    pre0 = eng.tracker.stats["prefill"].busy_time
    dec = eng.tracker.stats["decode"]
    dec0, tok0 = dec.busy_time, dec.iters_done
    q0, g0, c0 = eng.quanta, eng.prefill_groups, eng.decode_captures
    cs0 = eng.graphs.capture_seconds if eng.graphs else 0.0
    w0 = Counter(eng.widths_used)
    counters = _zero_counts()
    t = time.perf_counter()
    eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = {n: getattr(mod, attr) for n, (mod, attr) in counters.items()}
    pre = eng.tracker.stats["prefill"].busy_time - pre0
    d_s, d_tok = dec.busy_time - dec0, dec.iters_done - tok0
    caps = eng.decode_captures - c0
    cap_s = (eng.graphs.capture_seconds if eng.graphs else 0.0) - cs0
    widths = dict(sorted((Counter(eng.widths_used) - w0).items()))
    mode = ("graphs" if eng.graphs else "eager") + \
        ("" if eng.paged else ", dense")
    print(f"serve {cfg.name} ({mode}): {len(reqs)} requests, prompt lengths "
          f"{lens.tolist()}, max_new {max_new}: wall {wall:.3f} s, prefill "
          f"{pre:.3f} s over {eng.prefill_groups - g0} groups "
          f"({int(lens.sum()) / pre:.1f} prompt tok/s), decode "
          f"{eng.quanta - q0} quanta, {caps} captures ({cap_s:.3f} s); "
          f"{d_tok} tokens in {d_s:.3f} s over the other "
          f"{eng.quanta - q0 - caps} ({d_tok / d_s:.1f} tok/s); widths "
          f"{widths}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches "
          f"{launches}")
    if eng.paged:
        eng.alloc.check()
        check(len(eng.alloc.free) == eng.alloc.usable_pages,
              f"{cfg.name} ({mode}): page pool whole and every page free "
              "after the run")
    return reqs, launches


def _add_launches(entries, launches, where: str, path) -> None:
    """Add a run's launch counts to the kernel entries whose ``paths`` hold
    ``where`` (an entry counts the wrapper count it names in ``counter``,
    else its own; one wrapper count serves several entries, each for the
    head dims of its own paths, so every launch is counted once) and check
    that every kernel of ``path`` was launched on ``where``."""
    for e in entries:
        if where not in e["paths"]:
            continue
        n = launches[e.get("counter", e["name"])]
        e.setdefault("launches_by_path", {})[where] = n
        e["launches"] = e.get("launches", 0) + n
        if e["name"] in path:
            check(n > 0, f"{e['name']} launched on the {where} path "
                  f"({n} times)")


def serve_twice(eng, cfg, lens, prompts, max_new: int, path: list[str],
                entries: list[dict], twice: bool = True) -> list[list[int]]:
    """Serve one workload twice through ``eng`` (with CUDA graphs: one
    capture per live page-table width, replays after). Checks: every
    request finishes with in-vocabulary tokens, the pool is whole after
    each run, every kernel of ``path`` was launched in the first run (the
    counts are set to 0 just before it and read just after; a replay adds
    the launches its capture recorded), one capture per width, and the
    second run gives the same streams. Adds the first run's counts to
    ``entries``; returns the streams."""
    check(eng.graphs is not None, f"{cfg.name}: the engine replays CUDA "
          "graphs on the card by default")
    reqs, launches = serve_run(eng, cfg, lens, prompts, max_new)
    check(all(r.done and len(r.out) == max_new for r in reqs),
          f"{cfg.name}: every request finished with max_new tokens")
    check(all(0 <= t < cfg.vocab for r in reqs for t in r.out),
          f"{cfg.name}: every token is in the vocabulary")
    check(eng.decode_captures == len(eng.widths_used),
          f"{cfg.name}: one graph capture per live page-table width "
          f"({eng.decode_captures} for {sorted(eng.widths_used)})")
    _add_launches(entries, launches, cfg.name, path)
    if not twice:
        return [r.out for r in reqs]
    again, _ = serve_run(eng, cfg, lens, prompts, max_new)
    check([r.out for r in again] == [r.out for r in reqs],
          f"{cfg.name}: a second run of the workload gives the same streams")
    return [r.out for r in reqs]


def serve_eager(cfg, params, dev, lens, prompts, max_new: int, streams,
                pinned_f=None, **engine_kw) -> None:
    """Serve the workload once more through an engine of the same settings
    that runs the eager loop (``graphs=False``), check that the streams
    equal the graph engine's, and profile one eager quantum."""
    eng = build_engine(cfg, params, device=dev, graphs=False, **engine_kw)
    if pinned_f is not None:
        eng.tracker.f = lambda: pinned_f
    reqs, _ = serve_run(eng, cfg, lens, prompts, max_new)
    check([r.out for r in reqs] == streams, f"{cfg.name}: the eager loop "
          "gives the graph engine's streams")
    profile_phase(eng, cfg)
    del eng
    torch.cuda.empty_cache()


def sampled_phase(cfg, params, dev, lens, prompts, **engine_kw) -> None:
    """Sampled decoding (temperature 0.8, top-k 50, seed 0) through CUDA
    graphs and through the eager loop: the streams are expected identical
    (the registered generator advances its Philox offset at each replay as
    the eager draws do) and are checked so."""
    outs = []
    for graphs in (True, False):
        eng = build_engine(cfg, params, device=dev, graphs=graphs,
                           temperature=0.8, top_k=50, sample_seed=0,
                           **engine_kw)
        eng.tracker.f = lambda: PINNED_F
        reqs, _ = serve_run(eng, cfg, lens, prompts, 32)
        outs.append([r.out for r in reqs])
        del eng
        torch.cuda.empty_cache()
    same = sum(a == b for a, b in zip(*outs))
    print(f"{cfg.name} sampled (temperature 0.8, top-k 50): {same}/"
          f"{len(prompts)} streams identical between graphs and eager")
    check(outs[0] == outs[1], f"{cfg.name}: sampled streams through CUDA "
          "graphs equal the eager loop's")


# ------------------------------------------------------------ the tier pool
# the two tiers of examples/serve_multitier.py at full width: a short-context
# dense tier and a long-context paged tier over one parameter tree
POOL_TIERS = (("short", dict(paged=False, max_slots=8, max_len=1024,
                             decode_quantum=8)),
              ("long", dict(paged=True, max_slots=8, max_len=4096,
                            page_size=16, decode_quantum=8)))
POOL_MAX_NEW = 32


def pool_workload(vocab):
    """24 requests from numpy seed 0: 20 prompts of 16-900 tokens and 4 of
    1100-3000 that only "long" can hold."""
    rng = np.random.default_rng(0)
    lens = np.concatenate([rng.integers(16, 901, 20),
                           rng.integers(1100, 3001, 4)])
    return lens, [rng.integers(0, vocab, n).tolist() for n in lens]


def pool_engines(cfg, params, dev) -> list:
    return [build_engine(cfg, params, device=dev, **kw)
            for _, kw in POOL_TIERS]


def pool_over(engines, *, concurrent: bool, pinned: bool, policy=None):
    """A MultiEngine over ``engines`` (POOL_TIERS' names); ``pinned``: the
    routing speeds at the tiers' priors and every engine's HBB ratio at
    PINNED_F, so that two runs route and admit alike; else both
    measured."""
    from repro_torch.serve.multi_engine import EngineTier, MultiEngine
    meng = MultiEngine([EngineTier(name, eng) for (name, _), eng
                        in zip(POOL_TIERS, engines)],
                       concurrent=concurrent, policy=policy)
    for eng in engines:
        eng = getattr(eng, "engine", eng)
        if pinned:
            eng.tracker.f = lambda: PINNED_F
        else:
            vars(eng.tracker).pop("f", None)
    if pinned:
        meng.tracker.throughput = lambda name: 0.0
    return meng


def overlap_first_captures(capturing, stepping) -> dict:
    """Hold the first graph capture of tier ``capturing`` open until tier
    ``stepping`` has made one whole step (admission, prefill, its own first
    quantum's capture) on its stream from its thread, so that the first
    quanta of a concurrent pool capture while the other tier steps.
    Returns flags the caller checks: both waits met."""
    import threading
    in_capture, stepped = threading.Event(), threading.Event()
    flags = {"capture_waited": False, "step_waited": False}
    graphs = capturing.engine.graphs
    real_capture, real_step = graphs._capture, stepping.engine.step

    def capture(fn):
        calls = [0]

        def held():
            calls[0] += 1                      # 1: warm-up, 2: captured
            if calls[0] == 2 and not in_capture.is_set():
                in_capture.set()
                flags["capture_waited"] = stepped.wait(120)
            fn()
        return real_capture(held)

    def step():
        if stepped.is_set():
            return real_step()
        flags["step_waited"] = in_capture.wait(120)
        try:
            return real_step()
        finally:
            stepped.set()

    graphs._capture = capture
    stepping.engine.step = step
    return flags


def pool_run(meng, cfg, prompts, what: str, healthy: bool = True):
    """Serve the pool workload once through ``meng`` with every wrapper's
    launch count set to 0 just before and read just after → (requests,
    launch counts, wall seconds). Prints each tier's routed requests,
    decoded tokens, measured tok/s, captures and widths, and the pool's
    wall time and aggregate tok/s beside the card. Checks: every request
    done with POOL_MAX_NEW in-vocabulary tokens, no dead letter, with
    ``healthy`` no health transition, and every tier's slots empty and its
    page pool whole."""
    from repro_torch.serve.engine import Request
    reqs = [Request(rid=i, prompt=p, max_new=POOL_MAX_NEW)
            for i, p in enumerate(prompts)]
    counters = _zero_counts()
    t = time.perf_counter()
    meng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = {n: getattr(mod, attr) for n, (mod, attr) in counters.items()}
    tok = sum(len(r.out) for r in reqs)
    tiers = {}
    for t_ in meng.tiers:
        eng = getattr(t_.engine, "engine", t_.engine)
        st = meng.stats()["tiers"][t_.name]
        tiers[t_.name] = {"routed": st["routed"], "decoded": st["decoded"],
                          "tok_s": st["tok_s"], "health": st["health"],
                          "captures": eng.decode_captures,
                          "widths": dict(sorted(eng.widths_used.items()))}
    print("report " + json.dumps({
        "pool": what, "card": CARD, "wall_s": wall, "tokens": tok,
        "tok_s": tok / wall, "cycles": meng.cycles, "tiers": tiers,
        "launches": {k: v for k, v in launches.items() if v}}))
    check(all(r.done and len(r.out) == POOL_MAX_NEW for r in reqs)
          and all(0 <= x < cfg.vocab for r in reqs for x in r.out),
          f"pool {what}: every request done with {POOL_MAX_NEW} "
          "in-vocabulary tokens")
    check(not meng.dead_letters, f"pool {what}: no dead letter")
    if healthy:
        check(not meng.health_log, f"pool {what}: no health transition "
              f"({meng.health_log})")
    for t_ in meng.tiers:
        eng = getattr(t_.engine, "engine", t_.engine)
        whole = all(r is None for r in eng.slot_req)
        if eng.paged:
            eng.alloc.check()
            whole = whole and len(eng.alloc.free) == eng.alloc.usable_pages
        check(whole, f"pool {what}: tier {t_.name}'s slots empty and its "
              "page pool whole")
    return reqs, launches, wall


def pool_phase(cfg, params, dev, entries) -> None:
    """The heterogeneous tier pool over the full-width parameters already
    on the card: "short" (dense, 8 slots of 1024) and "long" (paged, 8
    slots of 4096) on the pool workload. With routing at the priors and
    admission pinned, a serial and a concurrent run (fresh engines each;
    in the concurrent run the long tier's first capture stays open while
    the short tier steps) must agree on assignments, streams and launch
    counts; then measured routing on the warm engines, concurrent and
    serial; then the bf16 agreement of "long"'s streams with one paged
    engine's (reported, not held: grouping differs, and bf16 rounding can
    flip a greedy token)."""
    from repro_torch.serve.engine import Engine, Request
    lens, prompts = pool_workload(cfg.vocab)
    long_ids = [i for i, n in enumerate(lens) if n >= POOL_TIERS[0][1][
        "max_len"]]
    runs = {}
    for concurrent in (False, True):
        what = "pinned, " + ("concurrent" if concurrent else "serial")
        engines = pool_engines(cfg, params, dev)
        meng = pool_over(engines, concurrent=concurrent, pinned=True)
        flags = (overlap_first_captures(meng.tiers[1], meng.tiers[0])
                 if concurrent else None)
        reqs, launches, wall = pool_run(meng, cfg, prompts, what)
        if concurrent:
            check(all(flags.values()), f"pool {what}: the long tier's first "
                  f"capture stayed open through a whole step of the short "
                  f"tier ({flags})")
        for t in meng.tiers:
            check(t.routed > 0 and t.engine.decode_captures
                  == len(t.engine.widths_used) > 0,
                  f"pool {what}: tier {t.name} routed {t.routed}, one "
                  f"capture per width ({t.engine.decode_captures} for "
                  f"{sorted(t.engine.widths_used)})")
        check(all(meng.assigned[i] == "long" for i in long_ids),
              f"pool {what}: every prompt longer than 1024 on long")
        runs[concurrent] = (dict(meng.assigned), [r.out for r in reqs],
                            launches, engines)
        del meng
        if not concurrent:
            del engines
            torch.cuda.empty_cache()
    (a_s, s_s, l_s, _), (a_c, s_c, l_c, engines) = runs[False], runs[True]
    check(a_s == a_c, "pool: serial and concurrent runs assign alike")
    check(s_s == s_c, "pool: serial and concurrent runs give the same "
          "streams")
    check(l_s == l_c, f"pool: serial and concurrent runs launch alike "
          f"({l_s} / {l_c})")
    _add_launches(entries, l_c, "pool",
                  ["flash_attention_fwd", "paged_attention_gqa"])
    for concurrent in (True, False):
        meng = pool_over(engines, concurrent=concurrent, pinned=False)
        pool_run(meng, cfg, prompts, "measured, " +
                 ("concurrent" if concurrent else "serial") +
                 ", warm engines")
    del engines, meng
    runs.clear()
    torch.cuda.empty_cache()
    eng = build_engine(cfg, params, device=dev, **POOL_TIERS[1][1])
    eng.tracker.f = lambda: PINNED_F
    ids = [i for i in range(len(prompts)) if a_c[i] == "long"]
    single = [Request(rid=i, prompt=prompts[i], max_new=POOL_MAX_NEW)
              for i in ids]
    eng.run(single)
    same = sum(r.out == s_c[r.rid] for r in single)
    first = [next((j for j, (x, y) in enumerate(zip(r.out, s_c[r.rid]))
                   if x != y), None) for r in single]
    print(f"pool bf16: {same}/{len(single)} of long's streams identical to "
          f"one paged engine's (first differing position per stream "
          f"{first}; reported, not held)")
    del eng
    torch.cuda.empty_cache()


def pool_fault_phase(cfg, params, dev) -> None:
    """Faults in the concurrent pool at full width in f32 (depth cut to 2
    layers): an unfailed run (which prewarms both tiers and measures their
    slowest step), then the same workload with a raise fault on "short"
    for two consecutive steps and a hang on "long" past its step deadline
    (three slowest steps, at least 0.5 s; the hang two deadlines): every
    request done, streams identical to the unfailed run's, "short"
    quarantined → probation → healthy, no capture at a width it had
    captured, no page leaked."""
    from repro_torch.serve.faults import Fault, FaultyEngine
    from repro_torch.serve.multi_engine import HealthPolicy
    _, prompts = pool_workload(cfg.vocab)
    engines = pool_engines(cfg, params, dev)
    steps = []
    for eng in engines:
        def timed(real=eng.step):
            t = time.perf_counter()
            rep = real()
            steps.append(time.perf_counter() - t)
            return rep
        eng.step = timed
    meng = pool_over(engines, concurrent=True, pinned=True)
    ref, _, _ = pool_run(meng, cfg, prompts, "f32 2 layers, unfailed")
    for eng in engines:
        del eng.step                            # the class's step again
    deadline = max(0.5, 3 * max(steps))
    widths = [set(e.widths_used) for e in engines]
    caps0 = [e.decode_captures for e in engines]
    engines[1].step_deadline_s = deadline
    faulty = [FaultyEngine(engines[0], [Fault(kind="raise", at=(1,), n=2)]),
              FaultyEngine(engines[1], [Fault(kind="hang", at=(2,),
                                              hang_s=2 * deadline)])]
    meng = pool_over(faulty, concurrent=True, pinned=True,
                     policy=HealthPolicy(quarantine_after=2,
                                         quarantine_cycles=1,
                                         probation_steps=1, retry_backoff=0))
    reqs, _, _ = pool_run(meng, cfg, prompts, "f32 2 layers, faulted",
                          healthy=False)
    print(f"pool faults: slowest unfailed step {max(steps):.3f} s, long's "
          f"deadline {deadline:.3f} s; fault logs "
          f"{[f.fault_log for f in faulty]}; health log {meng.health_log}; "
          f"retries {meng.retries}")
    check([r.out for r in reqs] == [r.out for r in ref],
          "pool faults: every stream identical to the unfailed pool's")
    check([k for _, k in faulty[0].fault_log] == ["raise", "raise"] and
          [k for _, k in faulty[1].fault_log] == ["hang"],
          "pool faults: the raise fault fired on two steps of short, the "
          "hang on one of long")
    states = [h["to"] for h in meng.health_log if h["tier"] == "short"]
    at = states.index("quarantined") if "quarantined" in states else -1
    check(at >= 0 and states[at:at + 3] == ["quarantined", "probation",
                                             "healthy"],
          f"pool faults: short went quarantined → probation → healthy "
          f"({states})")
    check(any(h["tier"] == "long" and "deadline" in h["reason"]
              for h in meng.health_log),
          "pool faults: long's hung step counted against its deadline")
    for eng, w, c in zip(engines, widths, caps0):
        new = set(eng.widths_used) - w
        check(eng.decode_captures - c == len(new),
              f"pool faults: no capture at a width already captured "
              f"({eng.decode_captures - c} captures, new widths "
              f"{sorted(new)})")
    del engines, faulty, meng
    torch.cuda.empty_cache()


# ------------------------------------------------------ speculative decode
SPEC_K = 4           # draft proposals a round
# the deep layers' residual projections scaled by benchmarks/bench_serve.py's
# SPEC_ALPHA, so the one-layer draft agrees with the target often
SPEC_ALPHA = 0.2
SPEC_PARTS = (("draft", "decode_step"), ("verify", "decode_verify"),
              ("commit", "decode_commit"))


def _rate(eng, before=None):
    """(decode tokens, seconds) the engine's tracker has recorded, or their
    change since ``before``."""
    dec = eng.tracker.stats["decode"]
    now = (dec.iters_done, dec.busy_time)
    return now if before is None else (now[0] - before[0], now[1] - before[1])


def spec_parts(eng, cfg) -> dict:
    """One eager speculative quantum of 8 full slots at ~1k context
    (:func:`fill_slots`) under torch.profiler, with a range around each
    part (the draft's ``decode_step``, ``decode_verify``,
    ``decode_commit``) → {part: [device ms, kernels]}, the kernels outside
    the ranges (acceptance and bookkeeping) under "accept"; {} if the
    profiler gave no device spans of the ranges. Aborts the slots after."""
    from torch.autograd import DeviceType
    from torch.profiler import record_function
    from repro_torch.serve import decode
    fill_slots(eng, cfg, 96)
    saved = {fn: getattr(decode, fn) for _, fn in SPEC_PARTS}

    def ranged(label, fn):
        def inner(*a, **k):
            with record_function("spec_" + label):
                return fn(*a, **k)
        return inner
    try:
        for label, fn in SPEC_PARTS:
            setattr(decode, fn, ranged(label, saved[fn]))
        with device_profile(cpu=True) as prof:
            eng.step()
    finally:
        for fn, f in saved.items():
            setattr(decode, fn, f)
    eng.abort()
    dev_ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans: dict[str, list] = {}
    for e in dev_ev:
        if e.name.startswith("spec_"):
            spans.setdefault(e.name[5:], []).append(
                (e.time_range.start, e.time_range.end))
    parts: dict[str, list] = {}
    if not spans:
        return parts
    for e in dev_ev:
        if e.name.startswith("spec_") or any(
                x in e.name for x in (LEAD_IN, "Memcpy", "Memset")):
            continue
        t = e.time_range.start
        lab = next((lab for lab, iv in spans.items()
                    if any(a <= t <= b for a, b in iv)), "accept")
        acc = parts.setdefault(lab, [0.0, 0])
        acc[0] += (e.time_range.end - t) / 1e3
        acc[1] += 1
    return parts


def spec_phase(cfg, params, dev, entries, lens, prompts) -> None:
    """Speculative big/little decode over the full-width parameters on the
    card: the target with its 39 deep layers' ``wo`` and ``w_down`` scaled
    by SPEC_ALPHA (``soften_deep_layers``, new tensors for those only) and
    a draft of its first layer (``draft_from_target``: embed, final norm
    and unembed shared), served paged with 8 slots of 4096, quanta of 8
    rounds of SPEC_K proposals. Checks: the softened target alone through
    graphs (reference streams and tok/s), the speculative engine through
    graphs twice (every request done with 32 in-vocabulary tokens, the
    pool whole, one capture per width, paged GQA and the flash forward
    launched on the "spec" path, each slot's device pos advanced by
    exactly the tokens the host appended, the same streams twice), eagerly
    (the graph runs' streams), and sampled (temperature 0.8, top-k 50, the
    first 6 prompts: graphs = eager).
    Reports how many bf16 spec streams equal the target-only ones, tok/s,
    acceptance, tokens a round, one profiled replayed quantum and one
    eager quantum's device time by part."""
    from repro_torch.models.draft import draft_from_target, soften_deep_layers
    from repro_torch.params import tree_leaves
    soft = soften_deep_layers(cfg, params, 1, SPEC_ALPHA)
    dcfg, dparams = draft_from_target(cfg, soft, 1)
    kw = dict(max_slots=8, max_len=4096, page_size=16, decode_quantum=8)
    spec = dict(draft_cfg=dcfg, draft_params=dparams, spec_k=SPEC_K)

    eng = build_engine(cfg, soft, device=dev, **kw)
    eng.tracker.f = lambda: PINNED_F
    ref, _ = serve_run(eng, cfg, lens, prompts, 32)
    ref_tok, ref_s = _rate(eng)
    del eng
    torch.cuda.empty_cache()

    eng = build_engine(cfg, soft, device=dev, **kw, **spec)
    eng.tracker.f = lambda: PINNED_F
    check(eng.graphs is not None and eng.quantum_tokens == 8 * (SPEC_K + 1),
          f"spec: graphs on, quantum_tokens {eng.quantum_tokens}")
    draft_mb = sum(t.numel() * t.element_size()
                   for t in tree_leaves(eng.draft_cache)) / 1e6
    advanced = []
    step = eng.step

    def pos_dev():
        with eng._on_stream():
            return eng.pos_dev.cpu().numpy()

    def checked_step():
        # the slots held before the step keep their requests through its
        # quantum: the device carry's advance is held to the tokens the
        # host appended, and to the host's mirror where the slot goes on
        held = {i: (r, len(r.out)) for i, r in enumerate(eng.slot_req)
                if r is not None}
        before = pos_dev()
        rep = step()
        after = pos_dev()
        advanced.extend(
            int(after[i] - before[i]) == len(r.out) - n0 and
            (eng.slot_req[i] is None or int(eng.pos_host[i]) == after[i])
            for i, (r, n0) in held.items())
        return rep
    eng.step = checked_step
    reqs, launches = serve_run(eng, cfg, lens, prompts, 32)
    spec_tok, spec_s = _rate(eng)
    check(all(r.done and len(r.out) == 32 for r in reqs) and
          all(0 <= t < cfg.vocab for r in reqs for t in r.out),
          "spec: every request finished with 32 in-vocabulary tokens")
    check(eng.decode_captures == len(eng.widths_used),
          f"spec: one graph capture per live page-table width "
          f"({eng.decode_captures} for {sorted(eng.widths_used)})")
    _add_launches(entries, launches, "spec",
                  ["flash_attention_fwd", "paged_attention_gqa"])
    again, _ = serve_run(eng, cfg, lens, prompts, 32)
    streams = [r.out for r in reqs]
    check([r.out for r in again] == streams,
          "spec: a second run through graphs gives the same streams")
    check(len(advanced) > 0 and all(advanced),
          f"spec: every slot's device pos advanced by exactly its emitted "
          f"tokens, and equals the host's mirror where the slot goes on "
          f"({sum(advanced)}/{len(advanced)} slot-quanta)")
    emitted = 2 * sum(len(r.out) - 1 for r in reqs)
    rounds = eng.spec_proposed / SPEC_K
    acceptance = eng.spec_accepted / eng.spec_proposed
    del eng.step
    replay = profile_phase(eng, cfg, max_new=96, drain=False)
    del eng
    torch.cuda.empty_cache()
    eng = build_engine(cfg, soft, device=dev, graphs=False, **kw, **spec)
    eng.tracker.f = lambda: PINNED_F
    eager, _ = serve_run(eng, cfg, lens, prompts, 32)
    eager_tok, eager_s = _rate(eng)
    check([r.out for r in eager] == streams,
          "spec: the eager loop gives the graph runs' streams")
    parts = spec_parts(eng, cfg)
    print(f"profile spec quantum: replayed {replay['busy_ms']:.3f} ms device "
          f"busy, {replay['kernels'] / kw['decode_quantum']:.0f} kernels a "
          f"round; eager, device [ms, kernels] by part {parts}")
    del eng
    torch.cuda.empty_cache()

    outs = []
    for graphs in (True, False):              # the first 6 prompts
        eng = build_engine(cfg, soft, device=dev, graphs=graphs,
                           temperature=0.8, top_k=50, sample_seed=0, **kw,
                           **spec)
        eng.tracker.f = lambda: PINNED_F
        sreqs, _ = serve_run(eng, cfg, lens[:6], prompts[:6], 32)
        outs.append([r.out for r in sreqs])
        del eng
        torch.cuda.empty_cache()
    check(outs[0] == outs[1], "spec sampled (temperature 0.8, top-k 50): "
          "streams through CUDA graphs equal the eager loop's")
    v_rel, c_rel = spec_module_rel(cfg, soft, dev, paged=True)
    print(f"spec bf16, 40 layers: decode_verify vs 5 serial steps, relative"
          f" max error {v_rel:.3g}; commit vs 3 serial writes {c_rel:.3g} "
          f"(reported, not held: the verify's projections run at M = 5 "
          f"rows, the steps' at 1)")
    same = sum(a == b for a, b in zip(streams, [r.out for r in ref]))
    first = [next((j for j, (x, y) in enumerate(zip(a, r.out)) if x != y),
                  None) for a, r in zip(streams, ref)]
    print("report " + json.dumps({
        "spec": "mistral-nemo-12b, soften 0.2, one-layer draft, spec_k 4",
        "card": CARD, "target_only_tok_s": ref_tok / ref_s,
        "spec_tok_s": spec_tok / spec_s, "spec_eager_tok_s":
        eager_tok / eager_s, "acceptance": acceptance,
        "tokens_a_round": emitted / rounds, "rounds": rounds,
        "same_as_target_only": same, "of": len(streams),
        "first_difference": first, "draft_cache_mb": draft_mb,
        "bf16_verify_rel": v_rel, "bf16_commit_rel": c_rel,
        "replay_busy_ms": replay["busy_ms"], "replay_wall_ms":
        replay["wall_ms"], "kernels_a_round":
        replay["kernels"] / kw["decode_quantum"],
        "eager_part_ms_kernels": parts}))
    del soft, dparams
    torch.cuda.empty_cache()


def spec_module_rel(cfg, params, dev, S: int = 100, n: int = 3,
                    paged: bool = True) -> tuple[float, float]:
    """``decode_verify`` of K = SPEC_K + 1 tokens after prefill(S) against K
    serial ``decode_step``s (relative max error of the logits), and
    ``decode_commit`` of the first ``n`` staged rows against n serial
    steps (relative max error over every cache leaf: pools but their trash
    page, rings, rows, Mamba-2 states), in the layout of
    :func:`prefilled_cache`."""
    from repro_torch.params import tree_leaves, tree_map
    from repro_torch.serve.decode import (decode_commit, decode_step,
                                          decode_verify)
    from repro_torch.serve.kv_cache import cache_kinds
    K = SPEC_K + 1
    toks, cache, table = prefilled_cache(cfg, params, dev, S, K, paged)
    pos0 = torch.tensor([S], dtype=torch.int32, device=dev)
    vt = toks[:, S:S + K]
    before = tree_map(lambda t: t.clone(), cache)
    logits, staged = decode_verify(cfg, params, cache, vt, pos0, table)
    serial, after = [], None
    c = tree_map(lambda t: t.clone(), cache)
    for j in range(K):
        lj, c = decode_step(cfg, params, c, vt[:, j], pos0 + j, table)
        serial.append(lj)
        if j == n - 1:
            after = tree_map(lambda t: t.clone(), c)
    want = torch.stack(serial, 1)
    check(bool(torch.isfinite(logits).all()), "verify logits are finite")
    check(all(torch.equal(a, b) for a, b in zip(tree_leaves(cache),
                                                tree_leaves(before))),
          f"{cfg.name}: decode_verify leaves the cache untouched")
    v_rel = float((logits - want).abs().max() / want.abs().max())
    decode_commit(cfg, cache, staged, pos0,
                  torch.tensor([n], dtype=torch.int32, device=dev), table)
    c_rel = 0.0
    for kind, got, ref in zip(cache_kinds(cfg, paged=paged),
                              cache["layers"], after["layers"]):
        for name, a in got.items():
            b = ref[name]
            if kind == "paged":        # the rejected rows' trash page 0
                a, b = a[1:], b[1:]
            c_rel = max(c_rel, float((a.float() - b.float()).abs().max() /
                                     b.float().abs().max().clamp_min(1e-30)))
    return v_rel, c_rel


def check_spec_module(cfg, params, dev, what: str, **kw) -> None:
    v_rel, c_rel = spec_module_rel(cfg, params, dev, **kw)
    check(v_rel < 1e-3 and c_rel < 1e-3,
          f"{cfg.name} {what}: decode_verify of {SPEC_K + 1} tokens ≡ "
          f"{SPEC_K + 1} serial decode steps (relative max error "
          f"{v_rel:.3g}), decode_commit of 3 ≡ 3 serial writes ({c_rel:.3g}"
          f") (tol 1e-3)")


# the f32 run's second layer scaled so little that the one-layer draft is
# accepted often: multi-row commits, the bonus token and whole rounds run
SPEC_F32_ALPHA = 0.05


def spec_f32_phase(cfg, params, dev) -> None:
    """Greedy speculative decode held to the target alone, in f32 at full
    width (depth cut to 2 layers): the target's second layer softened by
    SPEC_F32_ALPHA and the draft of its first layer, served paged (8 slots
    of 4096, quanta of 8 rounds of SPEC_K) through CUDA graphs beside the
    softened target alone: 8 prompts of 16–1000 tokens (numpy seed 2), 32
    new tokens each. Held: the same streams, every request done, one
    capture per width, and more than one token a round."""
    from repro_torch.models.draft import draft_from_target, soften_deep_layers
    soft = soften_deep_layers(cfg, params, 1, SPEC_F32_ALPHA)
    dcfg, dparams = draft_from_target(cfg, soft, 1)
    kw = dict(max_slots=8, max_len=4096, page_size=16, decode_quantum=8)
    rng = np.random.default_rng(2)
    lens = rng.integers(16, 1001, 8)
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in lens]
    outs = []
    for spec in ({}, dict(draft_cfg=dcfg, draft_params=dparams,
                          spec_k=SPEC_K)):
        eng = build_engine(cfg, soft, device=dev, **kw, **spec)
        eng.tracker.f = lambda: PINNED_F
        reqs, _ = serve_run(eng, cfg, lens, prompts, 32)
        check(all(r.done and len(r.out) == 32 for r in reqs) and
              eng.decode_captures == len(eng.widths_used),
              f"spec f32{' (target alone)' if not spec else ''}: every "
              f"request done with 32 tokens, one capture per width "
              f"({eng.decode_captures} for {sorted(eng.widths_used)})")
        outs.append([r.out for r in reqs])
    rounds = eng.spec_proposed / SPEC_K
    per_round = sum(len(o) - 1 for o in outs[1]) / rounds
    same = sum(a == b for a, b in zip(*outs))
    check(outs[0] == outs[1] and per_round > 1,
          f"spec f32, full width, 2 layers, soften {SPEC_F32_ALPHA}: greedy "
          f"streams through graphs equal the target alone's ({same}/"
          f"{len(outs[0])}); {per_round:.3f} tokens a round (> 1), "
          f"acceptance {eng.spec_accepted / eng.spec_proposed:.4f}")
    del eng, soft, dparams
    torch.cuda.empty_cache()


def serve_phase(dev, entries) -> None:
    from repro_torch.configs import get_config
    from repro_torch.params import init_params, n_params

    cfg = get_config("mistral-nemo-12b")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    print(f"{cfg.name}: {n_params(cfg) / 1e9:.3f} B params made on the card "
          f"in {time.perf_counter() - t0:.1f} s")
    kw = dict(max_slots=8, max_len=4096, page_size=16, decode_quantum=8)
    eng = build_engine(cfg, params, device=dev, **kw)
    rng = np.random.default_rng(0)
    lens = rng.integers(16, 2001, 12)
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in lens]
    streams = serve_twice(eng, cfg, lens, prompts, 32,
                          ["flash_attention_fwd", "paged_attention_gqa"],
                          entries)
    tok, sec = _rate(eng)
    SERVE_TOK_S[cfg.name] = tok / sec
    profile_phase(eng, cfg)
    del eng
    torch.cuda.empty_cache()
    serve_eager(cfg, params, dev, lens, prompts, 32, streams, **kw)
    sampled_phase(cfg, params, dev, lens, prompts, **kw)
    t0 = time.perf_counter()
    pool_phase(cfg, params, dev, entries)
    print(f"pool phase (bf16) {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    spec_phase(cfg, params, dev, entries, lens, prompts)
    print(f"spec phase (bf16) {time.perf_counter() - t0:.1f} s")
    rel = prefill_decode_rel(cfg, params, dev)
    print(f"full width bf16, 40 layers: prefill(S) + paged decode vs "
          f"prefill(S+1), relative max error {rel:.3g} (reported, not held:"
          f" bf16 rounding through 40 random layers)")
    del params
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, n_layers=2, param_dtype="float32")
    params32 = init_params(cfg32, seed=0, device=dev)
    rel = prefill_decode_rel(cfg32, params32, dev)
    check(rel < 1e-3, f"full width f32, depth cut to 2 layers: prefill(S) + "
          f"paged decode ≡ prefill(S+1), relative max error {rel:.3g} "
          f"(tol 1e-3)")
    check_spec_module(cfg32, params32, dev, "full width f32, depth cut to 2 "
                      "layers, paged")
    t0 = time.perf_counter()
    spec_f32_phase(cfg32, params32, dev)
    print(f"spec f32 phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    pool_fault_phase(cfg32, params32, dev)
    print(f"pool fault phase (f32) {time.perf_counter() - t0:.1f} s")
    del params32
    torch.cuda.empty_cache()


def deepseek_phase(dev, entries) -> None:
    """deepseek-v2-236b at its published width (d 5120, 128 heads, MLA
    kv_lora 512 / q_lora 1536 / rope 64, 160 routed experts top-6 + 2
    shared, expert hidden 1536, dense first layer 12288, vocab 102400),
    depth cut to 6 layers (the dense layer and 5 MoE layers, 21.25 B
    params) so the bf16 weights fit one card."""
    from repro_torch.configs import get_config
    from repro_torch.params import init_params, n_params

    cfg = dataclasses.replace(get_config("deepseek-v2-236b"), n_layers=6)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    print(f"{cfg.name}, depth cut to {cfg.n_layers} layers: "
          f"{n_params(cfg) / 1e9:.3f} B params made on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    kw = dict(max_slots=8, max_len=2048, page_size=16, decode_quantum=8)
    eng = build_engine(cfg, params, device=dev, **kw)
    eng.tracker.f = lambda: PINNED_F
    rng = np.random.default_rng(0)
    lens = rng.integers(16, 1001, 8)
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in lens]
    streams = serve_twice(eng, cfg, lens, prompts, 16,
                          ["flash_attention_fwd", "paged_attention_mla",
                           "grouped_gemm"], entries)
    profile_phase(eng, cfg)
    del eng
    torch.cuda.empty_cache()
    serve_eager(cfg, params, dev, lens, prompts, 16, streams,
                pinned_f=PINNED_F, **kw)
    del params
    torch.cuda.empty_cache()
    m = cfg.moe
    cf = m.n_experts / m.top_k
    cfg32 = dataclasses.replace(cfg, n_layers=2, param_dtype="float32",
                                moe=dataclasses.replace(m,
                                                        capacity_factor=cf))
    print(f"f32 check: capacity_factor raised from {m.capacity_factor} to "
          f"{cf:.4g} so that no token is dropped at prefill (Ce >= tokens); "
          "decode never drops")
    params32 = init_params(cfg32, seed=0, device=dev)
    rel = prefill_decode_rel(cfg32, params32, dev)
    check(rel < 1e-3, f"{cfg.name} full width f32, depth cut to 2 layers "
          f"(dense + MoE): prefill(S) + paged decode ≡ prefill(S+1), "
          f"relative max error {rel:.3g} (tol 1e-3)")
    check_spec_module(cfg32, params32, dev, "full width f32, depth cut to 2 "
                      "layers (dense + MoE), paged MLA")
    del params32
    torch.cuda.empty_cache()


def mamba_phase(dev, entries) -> None:
    """mamba2-130m at its published width and depth (24 Mamba-2 layers, d
    768, d_inner 1536, 24 heads of 64, N 128, conv 4, chunk 256, V 50280,
    tied embeddings; random weights made on the card from seed 0). Its
    prefill runs in exact-length groups (a state scan would absorb pad
    tokens) through the SSD kernel; decode steps the per-slot state."""
    from repro_torch.configs import get_config
    from repro_torch.params import init_params, n_params

    cfg = get_config("mamba2-130m")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    print(f"{cfg.name}: {n_params(cfg) / 1e6:.3f} M params made on the card "
          f"in {time.perf_counter() - t0:.1f} s")
    kw = dict(max_slots=8, max_len=4096, page_size=16, decode_quantum=8)
    eng = build_engine(cfg, params, device=dev, **kw)
    check(not eng.pad_safe, f"{cfg.name}: exact-length prefill (pad_safe "
          "False)")
    rng = np.random.default_rng(0)
    lens = rng.integers(16, 2001, 12)
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in lens]
    from repro_torch.kernels.ssd import ops as ssd_ops
    before = dict(ssd_ops.route_launches)
    streams = serve_twice(eng, cfg, lens, prompts, 32, ["ssd_intra_chunk"],
                          entries)
    routes = {r: n - before[r] for r, n in ssd_ops.route_launches.items()}
    check(routes["f32"] == 0 and routes["mma"] > 0, f"{cfg.name}: every SSD "
          f"launch of both runs on the tensor-core route ({routes})")
    prefill_profile(cfg, params, prompts[int(np.argmax(lens))], dev)
    profile_phase(eng, cfg)
    del eng
    torch.cuda.empty_cache()
    serve_eager(cfg, params, dev, lens, prompts, 32, streams, **kw)
    del params
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, param_dtype="float32")
    params32 = init_params(cfg32, seed=0, device=dev)
    rel = prefill_decode_rel(cfg32, params32, dev)
    check(rel < 1e-3, f"{cfg.name} full width and depth, f32: prefill(S) + "
          f"decode ≡ prefill(S+1), relative max error {rel:.3g} (tol 1e-3)")
    check_spec_module(cfg32, params32, dev, "full width and depth, f32 "
                      "(the staged Mamba-2 states)")
    del params32
    torch.cuda.empty_cache()


@contextmanager
def plain_calls():
    """Counts of the calls of every kernel's plain version (each function
    ``*_ref`` of the kernels' ``ref.py`` modules, which the wrappers call)
    that were given a tensor on the card, by name, over the block."""
    import importlib
    calls: Counter = Counter()
    saved = []
    for kernel in ("flash_attention", "gemm", "grouped_gemm",
                   "paged_attention", "selective_scan", "ssd"):
        mod = importlib.import_module(f"repro_torch.kernels.{kernel}.ref")
        for name in [n for n in vars(mod) if n.endswith("_ref")]:
            fn = getattr(mod, name)

            def counted(*a, _fn=fn, _name=f"{kernel}.{name}", **kw):
                if any(isinstance(x, torch.Tensor) and x.is_cuda
                       for x in (*a, *kw.values())):
                    calls[_name] += 1
                return _fn(*a, **kw)

            saved.append((mod, name, fn))
            setattr(mod, name, counted)
    try:
        yield calls
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


JAMBA_DEPTH = 8


def jamba_phase(dev, entries) -> None:
    """jamba-v0.1-52b at its published width (d 4096, 32 heads over 8 of
    128 without RoPE, Mamba-1 with d_inner 8192, N 16, conv 4 and dt rank
    256, 16 experts top-2 of 14336 on the odd layers and dense SwiGLU FFNs
    of 14336 on the even ones, vocab 65536), depth cut to 8 layers: one
    whole period of its schedule (7 Mamba-1 layers, attention at slot 4),
    13.30 B params. Exact-length prefill groups run the selective scan,
    the flash forward and the grouped GEMM's prefill path; decode runs
    paged GQA on the attention layer, the grouped GEMM's decode path and
    the Mamba-1 step in plain torch, each quantum one CUDA graph. The mistral
    workload through the paged engine twice with graphs (no plain version
    called on the card), profiled (the longest prompt's prefill group and
    a quantum), once eagerly (the same streams; both grouped-GEMM paths
    launched) and once through the dense engine (streams reported beside
    the paged engine's); then at f32 (capacity factor raised so no token
    is dropped), prefill(S) + decode ≡ prefill(S + 1) through the paged and
    the dense layout."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.grouped_gemm import ops as gg_ops

    cfg = dataclasses.replace(get_config("jamba-v0.1-52b"),
                              n_layers=JAMBA_DEPTH)
    params = _make_params(cfg, dev)
    kw = dict(max_slots=8, max_len=4096, page_size=16, decode_quantum=8)
    eng = build_engine(cfg, params, device=dev, **kw)
    eng.tracker.f = lambda: PINNED_F
    check(not eng.pad_safe and eng.kinds == ["dense"] * 4 + ["paged"]
          + ["dense"] * 3, f"{cfg.name}: exact-length prefill (pad_safe "
          f"{eng.pad_safe}); the attention layer paged, the Mamba-1 layers' "
          f"state per slot ({eng.kinds})")
    rng = np.random.default_rng(0)
    lens = rng.integers(16, 2001, 12)
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in lens]
    with plain_calls() as plain:
        streams = serve_twice(eng, cfg, lens, prompts, 32,
                              ["flash_attention_fwd", "paged_attention_gqa",
                               "grouped_gemm", "selective_scan"], entries)
    check(not plain, f"{cfg.name}: no plain version ran on the card in the "
          f"two graph runs ({dict(plain)})")
    prefill_profile(cfg, params, prompts[int(np.argmax(lens))], dev,
                    "selective_scan")
    profile_phase(eng, cfg)
    del eng
    torch.cuda.empty_cache()
    before = dict(gg_ops.route_launches)
    with plain_calls() as plain:
        serve_eager(cfg, params, dev, lens, prompts, 32, streams,
                    pinned_f=PINNED_F, **kw)
    routes = {r: n - before[r] for r, n in gg_ops.route_launches.items()}
    check(routes["prefill"] > 0 and routes["decode"] > 0 and
          routes["f32"] == 0 and not plain, f"{cfg.name} (eager): the "
          f"grouped GEMM's prefill and decode paths both launched "
          f"({routes}), no plain version on the card ({dict(plain)})")
    dense = build_engine(cfg, params, device=dev, paged=False, **kw)
    dense.tracker.f = lambda: PINNED_F
    reqs, _ = serve_run(dense, cfg, lens, prompts, 32)
    check(all(r.done and len(r.out) == 32 for r in reqs) and
          all(0 <= t < cfg.vocab for r in reqs for t in r.out),
          f"{cfg.name} (dense engine): every request finished with 32 "
          "in-vocabulary tokens")
    diverge = [next((i for i, (a, b) in enumerate(zip(r.out, s))
                     if a != b), None) for r, s in zip(reqs, streams)]
    same = sum(d is None for d in diverge)
    print("report " + json.dumps({
        "report": f"{cfg.name} dense engine against the paged engine, bf16",
        "streams_equal": same, "streams": len(reqs),
        "first_divergence": diverge,
        "why": "the dense engine's attention layer decodes in plain torch "
               "(f32 einsum over dense rows) and the paged engine's "
               "through the paged GQA kernel (bf16 products, f32 sums): "
               "their logits differ by rounding, and a near-tied argmax of "
               "random weights can flip",
        "card": CARD}))
    del dense, reqs, params
    torch.cuda.empty_cache()
    m = cfg.moe
    cf = m.n_experts / m.top_k
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                moe=dataclasses.replace(m,
                                                        capacity_factor=cf))
    print(f"f32 check: capacity_factor raised from {m.capacity_factor} to "
          f"{cf:.4g} so that no token is dropped at prefill (Ce >= tokens); "
          "decode never drops")
    params32 = _make_params(cfg32, dev)
    for paged in (True, False):
        rel = prefill_decode_rel(cfg32, params32, dev, paged=paged)
        check(rel < 1e-3, f"{cfg.name} full width f32, depth "
              f"{JAMBA_DEPTH} ({'paged' if paged else 'dense'} layout): "
              f"prefill(S) + decode ≡ prefill(S+1), relative max error "
              f"{rel:.3g} (tol 1e-3)")
    del params32
    torch.cuda.empty_cache()


# ------------------------------------------ memory of every engine built here
MEMORY_SEEN: dict = {}


def check_cache_bytes(eng) -> None:
    """An engine's ``reserved_cache_bytes()`` against the sum of its cache
    tensors' bytes and against the layout's bytes from the memory helpers:
    ``cache_bytes(cfg, slots, max_len)``, and for a paged engine each
    pooled layer's slot rows (``slots · page_bytes(cfg, max_len)``)
    replaced by its pool (``num_pages · page_bytes(cfg, page_size)``).
    Printed and held once for each layout, held again at every build."""
    from repro_torch.serve.kv_cache import cache_bytes, page_bytes
    cfg = eng.cfg
    got = eng.reserved_cache_bytes()
    leaves = sum(t.nbytes for layer in eng.cache["layers"]
                 for t in layer.values())
    want = cache_bytes(cfg, eng.max_slots, eng.max_len)
    if eng.paged:
        want += eng.num_pages * page_bytes(cfg, eng.page_size) - \
            eng.max_slots * page_bytes(cfg, eng.max_len)
    key = (cfg.name, cfg.n_layers, cfg.param_dtype, eng.paged,
           eng.max_slots, eng.max_len, eng.num_pages if eng.paged else 0)
    ok = got == leaves == want
    if key in MEMORY_SEEN and ok:
        return
    MEMORY_SEEN[key] = got
    layout = (f"paged, {eng.num_pages} pages of {eng.page_size}"
              if eng.paged else "dense")
    check(ok, f"memory {cfg.name} depth {cfg.n_layers} {cfg.param_dtype} "
          f"({layout}, {eng.max_slots} slots of {eng.max_len}): "
          f"reserved_cache_bytes {got} = the cache tensors' {leaves} = "
          f"cache_bytes/page_bytes {want} ({got / 2**30:.3f} GiB)")


def build_engine(cfg, params, **kw):
    """An ``Engine`` held to :func:`check_cache_bytes` as soon as it is
    built: every engine this script serves on is built here."""
    from repro_torch.serve.engine import Engine
    eng = Engine(cfg, params, **kw)
    check_cache_bytes(eng)
    return eng


# --------------------------------------------------- jamba speculative decode
SERVE_TOK_S: dict = {}       # graph decode tok/s of a serve phase, by model
# jamba's residual projections and its draft's scaled so far that the
# logits lean on the shared embedding and unembedding: a one-layer f32
# jamba and the draft agree on 0/14 argmaxes at 0.05, 6/14 at 0.002,
# 14/14 at 0.0005 (tools/jamba_draft_agreement.py, on the CPU)
JAMBA_SPEC_ALPHA = 1e-3


def soften_all(params, alpha: float):
    """Every layer's residual projections (attention and Mamba ``wo``, the
    dense and expert ``w_down``) scaled by ``alpha`` IN PLACE: the target's
    logits lean on its embedding and unembedding, which its draft shares,
    so proposals are often accepted (``soften_deep_layers`` for a hybrid,
    whose first layer is no draft)."""
    for layer in params["layers"]:
        for block in layer.values():
            if isinstance(block, dict):
                for name in ("wo", "w_down"):
                    if name in block:
                        block[name].mul_(alpha)


def jamba_draft(cfg, params, dev, seed: int = 1):
    """A one-layer dense GQA draft at jamba's width and vocab (32 heads over
    8 of 128, no RoPE, SwiGLU of 14336) with seeded weights, sharing the
    target's embedding, final norm and unembedding, its layer softened by
    JAMBA_SPEC_ALPHA → (draft cfg, params)."""
    from repro_torch.params import init_params
    dcfg = dataclasses.replace(cfg, name=f"{cfg.name} draft (1 dense GQA "
                               "layer)", family="dense", n_layers=1,
                               ssm=None, moe=None)
    layer = init_params(dataclasses.replace(dcfg, vocab=1), seed=seed,
                        device=dev)["layers"]
    dparams = {"embed": params["embed"], "layers": layer,
               "final_norm": params["final_norm"],
               "unembed": params["unembed"]}
    soften_all(dparams, JAMBA_SPEC_ALPHA)
    return dcfg, dparams


def jamba_spec_phase(dev, entries) -> None:
    """Speculative decode with a Mamba-1 target: jamba-v0.1-52b at its
    published width, depth cut to 8 (``jamba_phase``'s model), every
    layer's ``wo``/``w_down`` scaled by JAMBA_SPEC_ALPHA
    (:func:`soften_all`),
    and :func:`jamba_draft`; ``jamba_phase``'s workload, paged with 8 slots
    of 4096 and quanta of 8 rounds of SPEC_K proposals. The target alone
    through graphs (reference streams and tok/s); the speculative engine
    through graphs twice and eagerly (every request done with 32
    in-vocabulary tokens, the pool whole, one capture per width, the three
    runs' streams equal; its kernels launched on the "jamba-spec" path:
    the flash forward and the selective scan in the prefills, paged GQA
    on the verify rows, the grouped GEMM's prefill and decode paths in the
    MoE layers, no plain version on the card), then once through the dense
    engine (streams reported). The staged Mamba-1 states of a verify live
    in the captured graph's pool: their bytes are printed beside the
    graph's. At f32 (capacity factor raised so no token is dropped), depth
    8: greedy spec streams through graphs equal the target alone's, paged
    and dense."""
    from repro_torch.configs import get_config
    from repro_torch.models.mamba import mamba_state_defs
    from repro_torch.serve.kv_cache import defs_bytes

    cfg = dataclasses.replace(get_config("jamba-v0.1-52b"),
                              n_layers=JAMBA_DEPTH)
    params = _make_params(cfg, dev)
    soften_all(params, JAMBA_SPEC_ALPHA)
    dcfg, dparams = jamba_draft(cfg, params, dev)
    kw = dict(max_slots=8, max_len=4096, page_size=16, decode_quantum=8)
    spec = dict(draft_cfg=dcfg, draft_params=dparams, spec_k=SPEC_K)
    rng = np.random.default_rng(0)
    lens = rng.integers(16, 2001, 12)
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in lens]
    n_mamba = sum(not cfg.is_attn_layer(i) for i in range(cfg.n_layers))
    staged = (SPEC_K + 1) * n_mamba * defs_bytes(mamba_state_defs(cfg, 8))
    print(f"{cfg.name} spec: the verify stages {SPEC_K + 1} states of "
          f"{n_mamba} Mamba-1 layers for 8 slots, {staged / 2**20:.1f} MiB")

    eng = build_engine(cfg, params, device=dev, **kw)
    eng.tracker.f = lambda: PINNED_F
    ref, _ = serve_run(eng, cfg, lens, prompts, 32)
    ref_tok, ref_s = _rate(eng)
    del eng
    torch.cuda.empty_cache()

    runs, rates = [], []
    for graphs in (True, True, False):
        if graphs and runs:
            eng = runs[-1][0]                      # the second graph run
        else:
            eng = build_engine(cfg, params, device=dev, graphs=graphs, **kw,
                               **spec)
            eng.tracker.f = lambda: PINNED_F
        before = _rate(eng)
        mem0 = torch.cuda.memory_reserved()
        with plain_calls() as plain:
            reqs, launches = serve_run(eng, cfg, lens, prompts, 32)
        rates.append(_rate(eng, before))
        runs.append((eng, reqs, launches, dict(plain),
                     torch.cuda.memory_reserved() - mem0))
        mode = "graphs" if graphs else "eager"
        check(all(r.done and len(r.out) == 32 for r in reqs) and
              all(0 <= t < cfg.vocab for r in reqs for t in r.out) and
              not plain, f"{cfg.name} spec ({mode}): every request finished "
              f"with 32 in-vocabulary tokens, no plain version on the card "
              f"({dict(plain)})")
        if graphs:
            check(eng.decode_captures == len(eng.widths_used),
                  f"{cfg.name} spec: one graph capture per live page-table "
                  f"width ({eng.decode_captures} for "
                  f"{sorted(eng.widths_used)})")
    g_eng = runs[0][0]
    _add_launches(entries, runs[0][2], "jamba-spec",
                  ["flash_attention_fwd", "paged_attention_gqa",
                   "grouped_gemm", "selective_scan"])
    streams = [[r.out for r in run[1]] for run in runs]
    check(streams[0] == streams[1] == streams[2], f"{cfg.name} spec: the "
          "two graph runs and the eager run give the same streams")
    acceptance = g_eng.spec_accepted / max(g_eng.spec_proposed, 1)
    rounds = g_eng.spec_proposed / SPEC_K
    emitted = sum(len(r.out) - 1 for run in runs[:2] for r in run[1])
    print(f"{cfg.name} spec: the first graph run's memory reserved grew "
          f"{runs[0][4] / 2**20:.0f} MiB (captures and their pools) beside "
          f"{staged / 2**20:.1f} MiB of staged Mamba-1 states a verify")
    del runs, g_eng, eng
    torch.cuda.empty_cache()
    dense = build_engine(cfg, params, device=dev, paged=False, **kw, **spec)
    dense.tracker.f = lambda: PINNED_F
    dreqs, _ = serve_run(dense, cfg, lens, prompts, 32)
    check(all(r.done and len(r.out) == 32 for r in dreqs) and
          dense.decode_captures == 1, f"{cfg.name} spec (dense engine): "
          f"every request finished with 32 tokens, one capture")
    same = sum(a == r.out for a, r in zip(streams[0], ref))
    print("report " + json.dumps({
        "spec": f"{cfg.name} depth {cfg.n_layers}, every layer softened "
                f"{JAMBA_SPEC_ALPHA}, one-layer dense GQA draft sharing "
                f"embed and unembed, spec_k {SPEC_K}", "card": CARD,
        "target_only_tok_s": ref_tok / ref_s,
        "spec_tok_s": rates[0][0] / rates[0][1],
        "spec_second_run_tok_s": rates[1][0] / rates[1][1],
        "spec_eager_tok_s": rates[2][0] / rates[2][1],
        "acceptance": acceptance, "tokens_a_round": emitted / rounds,
        "rounds": rounds, "same_as_target_only": same, "of": len(ref),
        "dense_same_as_paged": sum(a == r.out for a, r in
                                   zip(streams[0], dreqs)),
        "staged_state_mib": staged / 2**20}))
    del dense, params, dparams, ref, dreqs
    torch.cuda.empty_cache()

    m = cfg.moe
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                moe=dataclasses.replace(
                                    m, capacity_factor=m.n_experts / m.top_k))
    params32 = _make_params(cfg32, dev)
    soften_all(params32, JAMBA_SPEC_ALPHA)
    dcfg32, dparams32 = jamba_draft(cfg32, params32, dev)
    rng = np.random.default_rng(2)
    lens32 = rng.integers(16, 400, 8)
    prompts32 = [rng.integers(0, cfg.vocab, n).tolist() for n in lens32]
    kw32 = dict(max_slots=4, max_len=1024, page_size=16, decode_quantum=4)
    for paged in (True, False):
        outs = []
        for extra in ({}, dict(draft_cfg=dcfg32, draft_params=dparams32,
                               spec_k=SPEC_K)):
            eng = build_engine(cfg32, params32, device=dev, paged=paged,
                               **kw32, **extra)
            eng.tracker.f = lambda: PINNED_F
            reqs, _ = serve_run(eng, cfg32, lens32, prompts32, 24)
            outs.append([r.out for r in reqs])
            if extra:
                tpr = (sum(len(r.out) - 1 for r in reqs) /
                       max(eng.spec_proposed / SPEC_K, 1))
            del eng
            torch.cuda.empty_cache()
        check(outs[0] == outs[1] and tpr > 1, f"{cfg.name} spec f32, full "
              f"width, depth {cfg.n_layers}, "
              f"{'paged' if paged else 'dense'}: greedy streams through "
              f"graphs equal the target alone's ({len(outs[0])}/"
              f"{len(outs[0])} requests compared); {tpr:.3f} tokens a "
              "round (> 1: multi-row commits of the Mamba-1 states)")
    del params32, dparams32
    torch.cuda.empty_cache()


# ------------------------------------------------------------ the variants
def serve_variant(cfg, params, dev, entries, where: str, path,
                  lens, prompts, **kw) -> None:
    """One variant's serving: the workload through CUDA graphs (counts added
    on ``where``, every kernel of ``path`` launched, no plain version on
    the card) and through the eager loop, streams held equal."""
    outs = []
    for graphs in (True, False):
        eng = build_engine(cfg, params, device=dev, graphs=graphs, **kw)
        eng.tracker.f = lambda: PINNED_F
        with plain_calls() as plain:
            reqs, launches = serve_run(eng, cfg, lens, prompts, 16)
        check(all(r.done and len(r.out) == 16 for r in reqs) and
              all(0 <= t < cfg.vocab for r in reqs for t in r.out) and
              not plain, f"{where} ({'graphs' if graphs else 'eager'}): "
              f"every request finished with 16 in-vocabulary tokens, no "
              f"plain version on the card ({dict(plain)})")
        if graphs:
            _add_launches(entries, launches, where, path)
        outs.append([r.out for r in reqs])
        del eng
        torch.cuda.empty_cache()
    check(outs[0] == outs[1], f"{where}: bf16 greedy streams through CUDA "
          "graphs equal the eager loop's")


def variant_f32_rel(cfg, dev, paged: bool = True) -> float:
    """prefill(S) + decode ≡ prefill(S + 1) at f32 (an MoE's capacity
    factor raised so no token is dropped)."""
    over = dict(param_dtype="float32")
    if cfg.moe is not None:
        over["moe"] = dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k)
    cfg32 = dataclasses.replace(cfg, **over)
    params32 = _make_params(cfg32, dev)
    rel = prefill_decode_rel(cfg32, params32, dev, paged=paged)
    del params32
    torch.cuda.empty_cache()
    return rel


VARIANT_TRAIN = dict(B=2, steps=3, check_layers=2, check_tokens=256)


def variants_phase(dev, entries) -> None:
    """Block combinations no registered config uses, each a VARIANT of a
    registered model at its published width (``dataclasses.replace``,
    named so): phi3.5-moe-42b with ``act="relu2"`` (a non-gated MoE FFN:
    two grouped GEMMs around the activation), depth 2; jamba-v0.1-52b with
    ``use_post_norm``, depth 8 (attention at slot 4); mamba2-130m with
    ``use_post_norm`` (no FFN: ``post1`` alone), depth 2; deepseek-v2-236b
    with ``sliding_window`` 1024 and ``local_global_period`` 2 (windowed
    MLA on layer 0), depth 2, trained only. Each served variant: 8 prompts
    of 16-1000 tokens, 16 new each, paged, through graphs and eagerly
    (:func:`serve_variant`), and f32 prefill → decode ≡ a one-token-longer
    prefill (jamba's at depth 5, attention included). Each variant: 3
    train steps (batch 2 x 2048) with the f32 gradient check at depth 2
    (:func:`train_cell`)."""
    from repro_torch.configs import get_config

    def variant(arch, label, **over):
        base = get_config(arch)
        return dataclasses.replace(base, name=f"{base.name} [variant: "
                                   f"{label}]", **over)
    rng = np.random.default_rng(5)
    kw = dict(max_slots=8, max_len=2048, page_size=16, decode_quantum=8)
    served = (
        (variant("phi3.5-moe-42b-a6.6b", "relu2", act="relu2", n_layers=2),
         "variant moe-relu2", ["flash_attention_fwd", "paged_attention_gqa",
                               "grouped_gemm"], "train-moe-relu2",
         ("flash_attention_fwd_lse", "flash_attention_bwd", "grouped_gemm"),
         2),
        (variant("jamba-v0.1-52b", "post-norm", use_post_norm=True,
                 n_layers=JAMBA_DEPTH), "variant jamba-postnorm",
         ["flash_attention_fwd", "paged_attention_gqa", "grouped_gemm",
          "selective_scan"], "train-jamba-postnorm",
         ("selective_scan", "selective_scan_bwd", "grouped_gemm"), 5),
        (variant("mamba2-130m", "post-norm", use_post_norm=True,
                 n_layers=2), "variant mamba2-postnorm",
         ["ssd_intra_chunk"], "train-mamba2-postnorm", ("ssd_intra_chunk",),
         2))
    for cfg, where, path, twhere, tpath, f32_depth in served:
        lens = rng.integers(16, 1001, 8)
        prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in lens]
        t = time.perf_counter()
        params = _make_params(cfg, dev)
        serve_variant(cfg, params, dev, entries, where, path, lens, prompts,
                      **kw)
        del params
        torch.cuda.empty_cache()
        t_f32 = time.perf_counter()
        rel = variant_f32_rel(dataclasses.replace(cfg, n_layers=f32_depth),
                              dev)
        print(f"{where}: served in {t_f32 - t:.1f} s, f32 check "
              f"{time.perf_counter() - t_f32:.1f} s")
        check(rel < 1e-3, f"{cfg.name} full width f32, depth {f32_depth}: "
              f"prefill(S) + paged decode ≡ prefill(S+1), relative max "
              f"error {rel:.3g} (tol 1e-3)")
        train_cell(dev, entries, dataclasses.replace(cfg, n_layers=2),
                   twhere, tpath, **VARIANT_TRAIN)
    mla = variant("deepseek-v2-236b", "window 1024 on even layers",
                  sliding_window=1024, local_global_period=2, n_layers=2)
    train_cell(dev, entries, mla, "train-mla-window",
               ("flash_attention_fwd_lse_mla", "flash_attention_bwd_mla",
                "grouped_gemm"), moments="int8", **VARIANT_TRAIN)


# ------------------------------------------------- the gathered-view decode
def gather_phase(dev, entries) -> None:
    """mistral-nemo-12b at its published width and depth through the
    gathered-view decode (``Engine(paged_kernel=False)``: every decode step
    gathers each slot's whole 256-page table into 4096 contiguous rows and
    attends them in plain torch, one graph at the full width), on
    ``serve_phase``'s workload and settings: through graphs and eagerly,
    streams equal, no paged kernel launched (the wrappers' counts read
    zero) and no plain version called on the card (``plain_calls``), decode
    tok/s printed beside the kernel path's from ``serve_phase``. At f32,
    depth cut to 2, greedy streams through graphs equal the paged-kernel
    engine's."""
    from repro_torch.configs import get_config
    cfg = get_config("mistral-nemo-12b")
    params = _make_params(cfg, dev)
    kw = dict(max_slots=8, max_len=4096, page_size=16, decode_quantum=8)
    rng = np.random.default_rng(0)
    lens = rng.integers(16, 2001, 12)
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in lens]
    outs, rates = [], []
    for graphs in (True, False):
        eng = build_engine(cfg, params, device=dev, graphs=graphs,
                           paged_kernel=False, **kw)
        eng.tracker.f = lambda: PINNED_F
        with plain_calls() as plain:
            reqs, launches = serve_run(eng, cfg, lens, prompts, 32)
        mode = "graphs" if graphs else "eager"
        paged = {n: launches[n] for n in ("paged_attention_gqa",
                                          "paged_attention_mla")}
        check(all(r.done and len(r.out) == 32 for r in reqs) and
              not any(paged.values()) and not plain and
              set(eng.widths_used) == {eng.pages_per_slot},
              f"gather ({mode}): every request finished with 32 tokens, "
              f"no paged kernel launched ({paged}), no plain version on "
              f"the card ({dict(plain)}), every quantum at the full width "
              f"({dict(eng.widths_used)})")
        if graphs:
            _add_launches(entries, launches, "gather",
                          ["flash_attention_fwd"])
            check(eng.decode_captures == 1, "gather: one graph capture")
        rates.append(_rate(eng))
        outs.append([r.out for r in reqs])
        del eng
        torch.cuda.empty_cache()
    check(outs[0] == outs[1], "gather: the eager loop gives the graph run's "
          "streams")
    kernel = SERVE_TOK_S.get(cfg.name)
    print("report " + json.dumps({
        "gather": f"{cfg.name}, paged_kernel=False, 8 slots of 4096",
        "card": CARD, "gather_graphs_tok_s": rates[0][0] / rates[0][1],
        "gather_eager_tok_s": rates[1][0] / rates[1][1],
        "kernel_graphs_tok_s (serve_phase)": kernel}))
    del params
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, n_layers=2, param_dtype="float32")
    params32 = _make_params(cfg32, dev)
    streams = []
    for paged_kernel in (True, False):
        eng = build_engine(cfg32, params32, device=dev,
                           paged_kernel=paged_kernel, **kw)
        eng.tracker.f = lambda: PINNED_F
        reqs, _ = serve_run(eng, cfg32, lens[:8], prompts[:8], 32)
        streams.append([r.out for r in reqs])
        del eng
        torch.cuda.empty_cache()
    check(streams[0] == streams[1], "gather f32, full width, depth 2: "
          "greedy streams through graphs equal the paged-kernel engine's "
          f"({len(streams[0])} requests)")
    del params32
    torch.cuda.empty_cache()


# --------------------------------------------------------- sharded serving
SHARD_SPLITS = (2, 4)        # model-axis sizes of the shards-in-turn check
# the multi-rank run: serve_phase's engine and workload on every rank
SHARD_KW = dict(max_slots=8, max_len=4096, page_size=16, decode_quantum=8)
SHARD_MAX_NEW = 32
SHARD_TIMEOUT_S = 600


def shards_in_turn(dev, entries) -> None:
    """The kv_seq-sharded paged decode on one card: the main shape's pools
    (B 8, 256 pages of 16, Hkv 8, G 4, dh 128, bf16, §6 row 1's positions)
    cut into m offset slices of 16/m (m in ``SHARD_SPLITS``), the kernel
    run on each at base i·16/m, the partials merged by
    ``decode.combine_shards`` (the helper a mesh's ``_combine`` reduces
    with, here over the stacked slices) and held against the unsharded
    kernel at the bf16 tolerance of tests/test_kernels.py, and against the
    plain versions of the slices merged alike. Each slice's device ms and
    their sum beside the unsharded call's. Comparison launches: not
    counted on any path."""
    from repro_torch.kernels.paged_attention import ops, ref
    from repro_torch.serve.decode import combine_shards
    bf16 = torch.bfloat16
    q32, pk, pv, table, pos, pos_h = paged_gqa_inputs(
        dev, hkv=8, grp=4, dh=128, max_len=4096,
        pos_head=[4095, 0, 15, 16], dt=bf16)
    q = q32.to(bf16)
    N, ps, hkv, dh = pk.shape
    kw = dict(page_size=ps, scale=dh ** -0.5)
    o, m, l = ops.paged_attend_gqa(q, pk, pv, table, pos, 0, **kw)
    whole = o / l[..., None]
    whole_ms = sum(t for t, _ in kernels_ms(lambda: ops.paged_attend_gqa(
        q, pk, pv, table, pos, 0, **kw), 20)[0].values())

    def stacked(parts):
        return [torch.stack(x) for x in zip(*parts)]

    def merge(parts):
        return combine_shards(*stacked(parts), lambda t: t.amax(0),
                              lambda a, b: (a.sum(0), b.sum(0)))

    report = {}
    for n in SHARD_SPLITS:
        psl = ps // n
        slices = [(pk.view(N, n, psl, hkv, dh)[:, i].contiguous(),
                   pv.view(N, n, psl, hkv, dh)[:, i].contiguous())
                  for i in range(n)]
        calls = [functools.partial(ops.paged_attend_gqa, q, sk, sv, table,
                                   pos, i * psl, **kw)
                 for i, (sk, sv) in enumerate(slices)]
        got = merge([c() for c in calls])
        plain = merge([ref.paged_flash_decode_gqa_ref(
            q, sk, sv, table, pos, i * psl, **kw)
            for i, (sk, sv) in enumerate(slices)])
        err = float((got - whole).abs().max())
        close = bool(torch.allclose(got, whole, rtol=BF16_TOL, atol=BF16_TOL))
        e_plain = row_err(got, plain)
        ms = [sum(t for t, _ in kernels_ms(c, 20)[0].values())
              for c in calls]
        routes = {ops.gqa_route(bf16, 4, dh)}
        check(close and e_plain <= 1e-3,
              f"paged decode sharded in turn over {n} offset slices of "
              f"{psl} (base i·{psl}, page_size {ps}), merged by "
              f"combine_shards: max |merged - unsharded kernel| {err:.3g} "
              f"(bf16 tol {BF16_TOL}), |merged - merged plain| {e_plain:.3g}"
              f" of a row's largest (tol 1e-3); route {routes}")
        print(f"shards in turn m={n}: slices device "
              f"{[round(t, 4) for t in ms]} ms, sum {sum(ms):.4f} ms, "
              f"unsharded {whole_ms:.4f} ms ({CARD})")
        report[n] = {"slices_ms": ms, "sum_ms": sum(ms), "err": err,
                     "plain_row_err": e_plain}
    for e in entries:
        if e["name"] == "paged_attention_gqa":
            e["shards_in_turn"] = {"unsharded_ms": whole_ms, **report}


def _workload(vocab):
    """serve_phase's workload: 12 prompts of 16-2000 tokens (seed 0)."""
    rng = np.random.default_rng(0)
    lens = rng.integers(16, 2001, 12)
    return lens, [rng.integers(0, vocab, n).tolist() for n in lens]


def _shard_archs(m: int) -> tuple:
    """mistral-nemo-12b always; phi3.5-moe-42b (which one card cannot
    hold) on 4 cards."""
    return ("mistral-nemo-12b",) + (("phi3.5-moe-42b-a6.6b",)
                                    if m == 4 else ())


def _f32_cfg(arch: str):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch), n_layers=2,
                               param_dtype="float32")


def _serve_f32(cfg, params, dev, **kw) -> list:
    """The workload at f32, admission pinned, greedy: the streams."""
    from repro_torch.serve.engine import Engine, Request
    eng = Engine(cfg, params, device=dev, **SHARD_KW, **kw)
    eng.tracker.f = lambda: PINNED_F
    lens, prompts = _workload(cfg.vocab)
    reqs = [Request(rid=i, prompt=p, max_new=SHARD_MAX_NEW)
            for i, p in enumerate(prompts)]
    eng.run(reqs)
    return [r.out for r in reqs]


def sharded_rank(ctx, out_dir: str) -> None:
    """One NCCL rank of the multi-rank run: for each of ``_shard_archs``,
    the f32 depth-2 streams, then the bf16 model at its published depth
    served twice through graphs, admission pinned (the first run
    captures; the second's launch counts and decode tok/s are kept) and
    one replayed quantum profiled. Rank 0 prints; every rank saves what
    it saw and its failed checks."""
    m, rank = ctx.axis_size("model"), ctx.axis_index("model")
    if rank:                         # rank 0 prints for the ranks
        with contextlib.redirect_stdout(io.StringIO()):
            return _sharded_rank(ctx, out_dir, m, rank)
    return _sharded_rank(ctx, out_dir, m, rank)


def _sharded_rank(ctx, out_dir: str, m: int, rank: int) -> None:
    from repro_torch.configs import get_config
    from repro_torch.params import init_params
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.kv_cache import page_bytes
    dev = torch.device("cuda", torch.cuda.current_device())
    global CARD
    CARD = subprocess.run(
        ["nvidia-smi", "-i", str(dev.index), "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    out = {"rank": rank, "card": CARD}
    for arch in _shard_archs(m):
        cfg32 = _f32_cfg(arch)
        out[f"{arch}/f32"] = _serve_f32(
            cfg32, init_params(cfg32, seed=0, device=dev, ctx=ctx), dev,
            ctx=ctx)
        torch.cuda.empty_cache()
        cfg = get_config(arch)
        t0 = time.perf_counter()
        params = init_params(cfg, seed=0, device=dev, ctx=ctx)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        eng = Engine(cfg, params, device=dev, ctx=ctx, **SHARD_KW)
        # the two runs form the same prefill groups only at one admission
        # ratio: a group's padded shape moves its bf16 rounding (and MoE
        # capacity couples its rows)
        eng.tracker.f = lambda: PINNED_F
        pool = eng.num_pages * page_bytes(cfg, eng.page_size // m)
        check(eng.reserved_cache_bytes() == pool,
              f"{arch} rank {rank}: the pools hold {eng.page_size // m} of "
              f"each page's {eng.page_size} offsets "
              f"({eng.reserved_cache_bytes()} B = {pool} B)")
        lens, prompts = _workload(cfg.vocab)
        first, _ = serve_run(eng, cfg, lens, prompts, SHARD_MAX_NEW)
        before = _rate(eng)
        again, launches = serve_run(eng, cfg, lens, prompts, SHARD_MAX_NEW)
        tok, sec = _rate(eng, before)
        check([r.out for r in again] == [r.out for r in first] and all(
            r.done and len(r.out) == SHARD_MAX_NEW for r in again),
            f"{arch} over {m} ranks: every request done, a second run gives "
            "the same streams")
        prof = profile_phase(eng, cfg)
        out[arch] = {"tok_s": tok / sec, "launches": launches,
                     "captures": eng.decode_captures, "init_s": init_s,
                     "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                     "profile": prof, "streams": [r.out for r in again]}
        if rank == 0:
            print(f"sharded {arch} over {m} ranks (bf16, {cfg.n_layers} "
                  f"layers, graphs): decode {tok / sec:.1f} tok/s, one "
                  f"quantum {prof['wall_ms']:.1f} ms wall, device busy "
                  f"{prof['busy_ms']:.1f} ms "
                  f"({100 * prof['busy_ms'] / prof['wall_ms']:.1f} %), "
                  f"{eng.decode_captures} captures, weights made in "
                  f"{init_s:.1f} s ({CARD})", flush=True)
        del eng, params
        torch.cuda.empty_cache()
    out["failures"] = FAILURES
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def sharded_phase(dev, entries) -> None:
    """Serving across cards on the ``model`` axis. Part 1 always runs on
    one card (:func:`shards_in_turn`). Part 2 runs where the machine shows
    more than one card: m = min(4, cards) NCCL ranks
    (``launch/mesh.py::spawn_ranks``) serve mistral-nemo-12b (and on 4
    cards phi3.5-moe-42b, which one card cannot hold) at full width and
    published depth with serve_phase's engine settings through CUDA
    graphs (:func:`sharded_rank`); their f32 depth-2 greedy streams are
    held against one card's engine, every rank's streams and launch
    counts against rank 0's, and the launches of rank 0's second run are
    added to the kernels' entries ("<arch> sharded")."""
    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.params import init_params
    import tempfile
    shards_in_turn(dev, entries)
    n = torch.cuda.device_count()
    print(f"cards: {n}")
    print(subprocess.run(["nvidia-smi", "-L"], capture_output=True,
                         text=True).stdout.strip())
    if n < 2:
        print("sharded serving across cards: NOT RUN, this machine shows "
              f"{n} card; the multi-rank part needs 2 or more (the "
              "shards-in-turn check above ran)")
        return
    m = min(4, n)
    want = {}
    for arch in _shard_archs(m):
        cfg32 = _f32_cfg(arch)
        want[arch] = _serve_f32(cfg32, init_params(cfg32, seed=0,
                                                   device=dev), dev)
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        spawn_ranks(sharded_rank, m, d, device_type="cuda",
                    timeout=SHARD_TIMEOUT_S)
        print(f"{m} ranks ran in {time.perf_counter() - t0:.1f} s")
        ranks = []
        for i in range(m):
            with open(os.path.join(d, f"rank{i}.json")) as f:
                ranks.append(json.load(f))
    for r in ranks:
        FAILURES.extend(f"rank {r['rank']}: {x}" for x in r["failures"])
    for arch in _shard_archs(m):
        check(all(r[f"{arch}/f32"] == want[arch] for r in ranks),
              f"{arch} at f32, depth 2: the greedy streams of {m} ranks "
              "equal one card's engine's")
        check(all(r[arch]["streams"] == ranks[0][arch]["streams"] and
                  r[arch]["launches"] == ranks[0][arch]["launches"]
                  for r in ranks),
              f"{arch} bf16 over {m} ranks: every rank emitted the same "
              "streams and launched the same kernels")
        where = f"{arch} sharded"
        for e in entries:
            if e["name"] in ("paged_attention_gqa", "flash_attention_fwd",
                             "grouped_gemm"):
                e["paths"] = list(e["paths"]) + [where]
        path = ["paged_attention_gqa", "flash_attention_fwd"] + (
            ["grouped_gemm"] if "moe" in arch else [])
        _add_launches(entries, ranks[0][arch]["launches"], where, path)
        print("report " + json.dumps({
            "sharded": arch, "ranks": m, "card": ranks[0]["card"],
            "tok_s": ranks[0][arch]["tok_s"],
            "busy_share": ranks[0][arch]["profile"]["busy_ms"]
            / ranks[0][arch]["profile"]["wall_ms"],
            "peak_gib": [r[arch]["peak_gib"] for r in ranks],
            "launches": ranks[0][arch]["launches"]}))


def device_time(prof):
    """Device kernels of a profile, its lead-in left out: (busy µs as the
    union of their intervals, kernel count, {name: [µs, count]}). Counts
    the profiles whose every lead-in kernel the profiler lost in
    ``LEAD_INS``."""
    from torch.autograd import DeviceType
    # device activity only; "Command Buffer Full" marks a full launch queue
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and "Command Buffer Full" not in e.name]
    lead = [e for e in kernels if LEAD_IN in e.name]
    LEAD_INS["profiles"] += 1
    LEAD_INS["lost"] += not lead
    kernels = [e for e in kernels if LEAD_IN not in e.name]
    busy, end = 0.0, float("-inf")
    for a, b in sorted((e.time_range.start, e.time_range.end)
                       for e in kernels):
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    by_name: dict[str, list] = {}
    for e in kernels:
        acc = by_name.setdefault(e.name, [0.0, 0])
        acc[0] += e.time_range.end - e.time_range.start
        acc[1] += 1
    return busy, len(kernels), by_name


def print_top(by_name, n: int = 12) -> None:
    for name, (us, k) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[
            :n]:
        print(f"  {us / 1e3:9.3f} ms {k:6d}x  {name[:90]}")


def fill_slots(eng, cfg, max_new: int) -> None:
    """Every slot given a request of a 1024-token prompt (numpy seed 1) and
    ``max_new`` tokens, all admitted, then one more quantum stepped so that
    a graph engine has captured the width the next quantum replays."""
    from repro_torch.serve.engine import Request
    rng = np.random.default_rng(1)
    for i in range(eng.max_slots):
        eng.submit(Request(rid=100 + i, max_new=max_new,
                           prompt=rng.integers(0, cfg.vocab, 1024).tolist()))
    while eng.pending:                          # admit every request first
        eng.step()
    eng.step()
    torch.cuda.synchronize()


def profile_phase(eng, cfg, max_new: int = 64, drain: bool = True) -> dict:
    """One decode quantum of 8 full slots at ~1k context under
    torch.profiler (after :func:`fill_slots`): device busy share of the
    wall time, kernels per step, the kernels by device time; the paged
    kernels the profiler saw equal the launches their wrappers counted in
    that quantum (with graphs, what the replay added). Without ``drain``
    the slots are aborted after. → wall and busy ms, kernels."""
    from repro_torch.kernels.paged_attention import ops as paged_ops
    fill_slots(eng, cfg, max_new)
    c0 = eng.decode_captures
    n0 = paged_ops.launches + paged_ops.mla_launches
    with device_profile(cpu=True) as prof:
        t = time.perf_counter()
        rep = eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    counted = paged_ops.launches + paged_ops.mla_launches - n0
    if drain:
        eng.drain()
    else:
        eng.abort()
    mode = "graphs" if eng.graphs else "eager"
    if eng.graphs:
        check(eng.decode_captures == c0, f"{cfg.name}: the profiled quantum "
              "replayed a captured graph")
    busy, n, by_name = device_time(prof)
    print(f"profile {cfg.name} ({mode}): one decode quantum ({rep.decoded} "
          f"tokens, {eng.decode_quantum} steps, 8 slots at ~1k context, "
          f"profiler on): wall {wall * 1e3:.1f} ms, device busy "
          f"{busy / 1e3:.1f} ms ({busy / 1e4 / wall:.1f} %), {n} kernels "
          f"({n / eng.decode_quantum:.0f} per step)")
    paged = [(us, k) for name, (us, k) in by_name.items()
             if "paged_" in name or "mla_combine" in name]
    seen = sum(k for _, k in paged)
    if paged:
        print(f"  paged decode kernels: {sum(us for us, _ in paged) / 1e3:.3f}"
              f" ms device over {seen} launches")
    check(seen == counted, f"{cfg.name} ({mode}): the profiled quantum's "
          f"paged kernels ({seen}) equal the launches counted ({counted})")
    print_top(by_name)
    return {"wall_ms": wall * 1e3, "busy_ms": busy / 1e3, "kernels": n}


# kernel of a prefill profile → the substring of its device kernels' names
PREFILL_KERNELS = {"ssd_intra_chunk": "ssd_",
                   "selective_scan": "selective_scan",
                   "flash_attention_fwd": "flash_fwd"}


def prefill_profile(cfg, params, prompt, dev,
                    kernel: str = "ssd_intra_chunk") -> dict:
    """One prefill group of one prompt under torch.profiler: the engine's
    call (prompt_len, page_size 16), after one unprofiled run of it. Prints
    its wall time, the device busy share, ``kernel``'s device ms and
    launches (one a Mamba layer: the SSD kernel for Mamba-2, the selective
    scan for Mamba-1; one an attention layer: the flash forward) and the
    kernels by device time."""
    from repro_torch.serve.prefill import prefill
    mod, attr = _counters()[kernel]
    toks = torch.tensor([prompt], dtype=torch.int32, device=dev)
    pl = torch.tensor([len(prompt)], dtype=torch.int32, device=dev)

    def run():
        return prefill(cfg, params, toks, prompt_len=pl, page_size=16)

    run()
    torch.cuda.synchronize()
    n0 = getattr(mod, attr)
    with device_profile(cpu=True) as prof:
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    launches = getattr(mod, attr) - n0
    busy, n, by_name = device_time(prof)
    k_us = sum(us for name, (us, _) in by_name.items()
               if PREFILL_KERNELS[kernel] in name)
    rows = (f" {-(-len(prompt) // cfg.ssm.chunk)} chunk rows of "
            f"{cfg.ssm.chunk}," if cfg.ssm else "")
    print(f"profile: one {cfg.name} prefill group (1 x {len(prompt)} tokens,"
          f"{rows} {cfg.n_layers} layers, "
          f"profiler on): wall {wall * 1e3:.1f} ms, device busy "
          f"{busy / 1e3:.3f} ms ({busy / 1e4 / wall:.1f} %), {n} kernels; "
          f"{kernel} kernel {k_us / 1e3:.3f} ms device over {launches} "
          f"launches ({100 * k_us / busy:.1f} % of busy)")
    print_top(by_name, 15)
    return {"wall_ms": wall * 1e3, "busy_ms": busy / 1e3, "kernels": n,
            "kernel_ms": k_us / 1e3, "kernel_launches": launches}


def pooled_rows(cfg, rows, S: int, extra: int, dev):
    """The prefill rows of one prompt of S tokens (``prefill(...,
    page_size=16)``) in the paged engine's layout → (cache, page table):
    pooled layers' rows as pages 1.. of a pool of ceil((S + extra) / 16)
    pages of 16 (table (1, T)); ring and Mamba layers as they are."""
    from repro_torch.serve.kv_cache import cache_kinds
    ps = 16
    n_rows = -(-S // ps)
    T = -(-(S + extra) // ps)
    layers = []
    for kind, layer in zip(cache_kinds(cfg, paged=True), rows["layers"]):
        if kind == "dense":
            layers.append(layer)
            continue
        pool = {}
        for name, r in layer.items():
            p = r.new_zeros((1 + T, ps) + tuple(r.shape[2:]))
            p[1:1 + n_rows] = r[0].reshape((n_rows, ps) + tuple(r.shape[2:]))
            pool[name] = p
        layers.append(pool)
    table = torch.arange(1, 1 + T, dtype=torch.int32, device=dev)[None]
    return {"layers": layers}, table


def prefilled_cache(cfg, params, dev, S: int, extra: int = 1,
                    paged: bool = True, frontend_embed=None):
    """Tokens (1, S + extra) from seed 1 and the cache of their prefill(S)
    (with ``frontend_embed`` in its first positions, if given) → (tokens,
    cache, page table). ``paged``: the paged engine's layout
    (:func:`pooled_rows`); else the dense engine's (per-slot rows, table
    None). Ring layers (rings of min(window, S + 16) slots) and Mamba-2
    layers carry their rows and state either way."""
    from repro_torch.serve.prefill import prefill
    g = torch.Generator(device=dev).manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (1, S + extra), generator=g,
                         device=dev, dtype=torch.int32)
    fe = dict(frontend_embed=frontend_embed)
    if not paged:
        _, cache = prefill(cfg, params, toks[:, :S], max_len=S + 16, **fe)
        return toks, cache, None
    _, rows = prefill(cfg, params, toks[:, :S], max_len=S + 16,
                      page_size=16, **fe)
    cache, table = pooled_rows(cfg, rows, S, extra, dev)
    return toks, cache, table


def prefill_decode_rel(cfg, params, dev, S: int = 100,
                       paged: bool = True, frontend_embed=None) -> float:
    """prefill(S) + decode of token S against the last logits of
    prefill(S + 1): the relative max error (tests/test_serve.py's check),
    in the layout of :func:`prefilled_cache`, with ``frontend_embed`` in
    both prefills' first positions if given."""
    from repro_torch.serve.decode import decode_step
    from repro_torch.serve.prefill import prefill
    toks, cache, table = prefilled_cache(cfg, params, dev, S, 1, paged,
                                         frontend_embed)
    ref, _ = prefill(cfg, params, toks, frontend_embed=frontend_embed)
    pos = torch.tensor([S], dtype=torch.int32, device=dev)
    got, _ = decode_step(cfg, params, cache, toks[:, S], pos, table)
    check(bool(torch.isfinite(got).all()), "decode logits are finite")
    return float((got - ref).abs().max() / ref.abs().max())


# ------------------------------- nemotron-4-15b, gemma2-2b, h2o-danube-1.8b
def _make_params(cfg, dev):
    from repro_torch.params import init_params, n_params
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    print(f"{cfg.name}: {n_params(cfg) / 1e9:.3f} B params made on the card "
          f"in {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    return params


def serve_graphs_then_eager(cfg, params, dev, entries, lens, prompts,
                            path, **kw) -> list:
    """One run through CUDA graphs (counts, checks and a profiled replayed
    quantum), then one through the eager loop of an engine of the same
    settings (streams checked equal, a profiled eager quantum). Returns
    the graph run's streams."""
    eng = build_engine(cfg, params, device=dev, **kw)
    streams = serve_twice(eng, cfg, lens, prompts, 32, path, entries,
                          twice=False)
    profile_phase(eng, cfg)
    del eng
    torch.cuda.empty_cache()
    serve_eager(cfg, params, dev, lens, prompts, 32, streams, **kw)
    return streams


def nemotron_phase(dev, entries) -> None:
    """nemotron-4-15b at its published width and depth (32 layers, d 6144,
    48 heads over 8 of 128, squared-ReLU FFN of 24576 without a gate, vocab
    256000, untied; 15.63 B params, 31.3 GB in bf16) on the mistral serve
    workload through the paged engine."""
    from repro_torch.configs import get_config
    cfg = get_config("nemotron-4-15b")
    params = _make_params(cfg, dev)
    rng = np.random.default_rng(0)
    lens = rng.integers(16, 2001, 12)
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in lens]
    serve_graphs_then_eager(cfg, params, dev, entries, lens, prompts,
                            ["flash_attention_fwd", "paged_attention_gqa"],
                            max_slots=8, max_len=4096, page_size=16,
                            decode_quantum=8)
    rel = prefill_decode_rel(cfg, params, dev)
    print(f"{cfg.name} full width bf16, 32 layers: prefill(S) + paged "
          f"decode vs prefill(S+1), relative max error {rel:.3g} (reported,"
          " not held: bf16 rounding through 32 random layers)")
    del params
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, n_layers=2, param_dtype="float32")
    rel = prefill_decode_rel(cfg32, _make_params(cfg32, dev), dev)
    check(rel < 1e-3, f"{cfg.name} full width f32, depth cut to 2 layers: "
          f"prefill(S) + paged decode ≡ prefill(S+1), relative max error "
          f"{rel:.3g} (tol 1e-3)")
    torch.cuda.empty_cache()


def _long_workload(vocab):
    """8 prompts of 16–6000 tokens from numpy seed 0, the first two drawn
    from 4097–6000 so that at least two are longer than the window of
    4096: their rings are packed from a bucket of 8192 and their decode
    runs past position 4096."""
    rng = np.random.default_rng(0)
    lens = np.concatenate([rng.integers(4097, 6001, 2),
                           rng.integers(16, 6001, 6)])
    return lens, [rng.integers(0, vocab, n).tolist() for n in lens]


def gemma2_phase(dev, entries) -> None:
    """gemma2-2b at its published width and depth (26 layers alternating a
    window of 4096 and global attention, d 2304, 8 heads over 4 of 256,
    attention softcap 50, final softcap 30, sandwich post-norms, GeGLU
    9216, tied embeddings scaled by sqrt(d), vocab 256000; 2.61 B params)
    through the paged engine at max_len 8192: the 13 global layers in the
    page pool (paged GQA at dh 256), the 13 local layers in per-slot
    rings."""
    from repro_torch.configs import get_config
    cfg = get_config("gemma2-2b")
    params = _make_params(cfg, dev)
    lens, prompts = _long_workload(cfg.vocab)
    streams = serve_graphs_then_eager(
        cfg, params, dev, entries, lens, prompts,
        ["flash_attention_fwd_dh256", "paged_attention_gqa_dh256"],
        max_slots=8, max_len=8192, page_size=16, decode_quantum=8)
    last = max(len(p) + len(o) - 1 for p, o in zip(prompts, streams))
    check(last > cfg.sliding_window and int((lens > 4096).sum()) >= 2,
          f"{cfg.name}: {int((lens > 4096).sum())} prompts longer than the "
          f"window (rings packed from the 8192 bucket); decode reached "
          f"position {last} (> {cfg.sliding_window}: the rings wrap)")
    S = 4200
    rel = prefill_decode_rel(cfg, params, dev, S=S)
    check(rel < BF16_TOL, f"{cfg.name} full width bf16, 26 layers, S={S} "
          f"past the window: prefill(S) + decode (13 global layers through "
          f"paged_gqa_mma<256, 1>, 13 rings) vs prefill(S+1), relative max "
          f"error {rel:.3g} (tol {BF16_TOL}, the bf16 logits' limit)")
    del params
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, n_layers=2, param_dtype="float32")
    params32 = _make_params(cfg32, dev)
    rel = prefill_decode_rel(cfg32, params32, dev, S=S, paged=False)
    check(rel < 1e-3, f"{cfg.name} full width f32, depth cut to 2 layers (a "
          f"ring and a global layer), S={S}: prefill(S) + dense decode ≡ "
          f"prefill(S+1), relative max error {rel:.3g} (tol 1e-3)")
    rel = prefill_decode_rel(cfg32, params32, dev, S=S)
    check(rel < 1e-3, f"{cfg.name} full width f32, depth cut to 2 layers, "
          f"S={S}: prefill(S) + paged decode (the global layer through "
          f"paged_gqa_kernel<float, 2, 256>) ≡ prefill(S+1), relative max "
          f"error {rel:.3g} (tol 1e-3)")
    check_spec_module(cfg32, params32, dev, f"full width f32, depth cut to "
                      f"2 layers, S={S} past the window (a ring, a paged "
                      f"layer at dh 256, softcap 50)", S=S)
    del params32
    torch.cuda.empty_cache()


def danube_phase(dev, entries) -> None:
    """h2o-danube-1.8b at its published width and depth (24 layers, d 2560,
    32 heads over 8 of 80, a window of 4096 on every layer, SwiGLU 6912,
    vocab 32000; 1.83 B params) through the dense engine (``paged=False``)
    on gemma2's workload at max_len 8192: every layer a per-slot ring of
    4096; then one prefill group of the longest prompt profiled."""
    from repro_torch.configs import get_config
    cfg = get_config("h2o-danube-1.8b")
    params = _make_params(cfg, dev)
    lens, prompts = _long_workload(cfg.vocab)
    streams = serve_graphs_then_eager(
        cfg, params, dev, entries, lens, prompts,
        ["flash_attention_fwd_dh80"], paged=False, max_slots=8,
        max_len=8192, decode_quantum=8)
    last = max(len(p) + len(o) - 1 for p, o in zip(prompts, streams))
    check(last > cfg.sliding_window, f"{cfg.name}: decode reached position "
          f"{last} (> {cfg.sliding_window}: the rings wrap)")
    prof = prefill_profile(cfg, params, prompts[int(np.argmax(lens))], dev,
                           kernel="flash_attention_fwd")
    check(prof["kernel_launches"] == cfg.n_layers, f"{cfg.name}: the "
          f"profiled prefill launched the flash forward once a layer "
          f"({prof['kernel_launches']})")
    del params
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, n_layers=2, param_dtype="float32")
    rel = prefill_decode_rel(cfg32, _make_params(cfg32, dev), dev, S=4200,
                             paged=False)
    check(rel < 1e-3, f"{cfg.name} full width f32, depth cut to 2 layers, "
          f"S=4200 past the window: prefill(S) + dense decode ≡ "
          f"prefill(S+1), relative max error {rel:.3g} (tol 1e-3)")
    torch.cuda.empty_cache()


# ------------------------------------- whisper-large-v3 and internvl2-26b
WHISPER_REQUESTS, WHISPER_FRAMES = 8, 1500
WHISPER_PROMPT, WHISPER_STEPS = 4, 124      # decoder prompt, greedy steps
INTERNVL2_IMAGES, INTERNVL2_IMAGE_STEPS = 4, 32


@contextmanager
def flash_routes(which: str = "fwd_route"):
    """The route of every flash forward call (``which="bwd_route"``: every
    backward call) over the block, in order (the wrapper's ``fwd_route`` or
    ``bwd_route`` recorded)."""
    from repro_torch.kernels.flash_attention import ops
    routes, fn = [], getattr(ops, which)

    def recorded(*a, **kw):
        routes.append(fn(*a, **kw))
        return routes[-1]

    setattr(ops, which, recorded)
    try:
        yield routes
    finally:
        setattr(ops, which, fn)


def whisper_phase(dev, entries) -> None:
    """whisper-large-v3 at its published width and depth (32 encoder and 32
    decoder layers, d 1280, 20 heads of 64, gelu FFN 5120, vocab 51866,
    tied; 1.54 B params, bf16) through ``prefill_step_fn`` and
    ``serve_step_fn``: 8 requests of 1500 stub frame embeddings (seed 0,
    × 0.1) encoded by ``whisper_prefill`` (the flash forward, non-causal,
    one launch an encoder layer on the wgmma route, nothing else of the
    hand-written kernels), a 4-token decoder prompt fed through
    ``whisper_decode_step``, then 124 greedy steps (self and cross
    attention in plain torch). The counts are set to 0 before the prefill
    and read after the last step. Prints prefill seconds, decode tok/s, a
    profiled step (busy share, largest device shares) and the device ms of
    its 32 cross attentions; then at f32 with depth cut to 2 + 2, 8 decode
    steps held within 1e-3 of ``decode_hidden`` over the same tokens."""
    from repro_torch.configs import get_config
    from repro_torch.models.whisper import decode_hidden
    from repro_torch.serve.decode import (flash_decode_gqa, serve_step_fn,
                                          whisper_decode_step)
    from repro_torch.serve.prefill import prefill_step_fn, whisper_prefill

    cfg = get_config("whisper-large-v3")
    params = _make_params(cfg, dev)
    B = WHISPER_REQUESTS
    g = torch.Generator(device=dev).manual_seed(0)
    frames = torch.randn((B, WHISPER_FRAMES, cfg.d_model), generator=g,
                         device=dev) * 0.1
    prompt = torch.randint(0, cfg.vocab, (B, WHISPER_PROMPT), generator=g,
                           device=dev)
    positions = [torch.full((B,), t, dtype=torch.int32, device=dev)
                 for t in range(WHISPER_PROMPT + WHISPER_STEPS + 1)]
    prefill, step = prefill_step_fn(cfg), serve_step_fn(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = _zero_counts()
    with flash_routes() as routes, plain_calls() as plain:
        t0 = time.perf_counter()
        enc, cache = prefill(params, frames)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for t in range(WHISPER_PROMPT):
            logits, cache = step(params, cache, prompt[:, t], positions[t])
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        out = []
        for t in range(WHISPER_PROMPT, WHISPER_PROMPT + WHISPER_STEPS):
            tok = logits.argmax(-1)
            out.append(tok)
            logits, cache = step(params, cache, tok, positions[t])
        torch.cuda.synchronize()
        t3 = time.perf_counter()
    launches = {n: getattr(mod, attr) for n, (mod, attr) in counters.items()}
    toks = torch.stack(out, 1)
    check(tuple(enc.shape) == (B, WHISPER_FRAMES, cfg.d_model) and
          bool(torch.isfinite(enc).all()) and
          bool(torch.isfinite(logits).all()), f"{cfg.name}: encoder states "
          f"{tuple(enc.shape)} and the last logits finite")
    check(bool(((toks >= 0) & (toks < cfg.vocab)).all()),
          f"{cfg.name}: {WHISPER_STEPS} greedy tokens a request, all in the "
          "vocabulary")
    check(launches["flash_attention_fwd"] == cfg.n_enc_layers and
          routes == ["wgmma"] * cfg.n_enc_layers and
          sum(launches.values()) == cfg.n_enc_layers and not plain,
          f"{cfg.name}: the flash forward launched once an encoder layer "
          f"on the wgmma route ({launches['flash_attention_fwd']} launches, "
          f"routes {Counter(routes)}), no other hand-written kernel "
          f"({launches}) and no plain version on the card ({dict(plain)})")
    _add_launches(entries, launches, cfg.name,
                  ["flash_attention_fwd_whisper"])
    torch.cuda.synchronize()
    t = time.perf_counter()
    whisper_prefill(cfg, params, frames)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t
    dec_s = t3 - t2
    print(f"serve {cfg.name}: {B} requests of {WHISPER_FRAMES} frames: "
          f"prefill (encoder + cross K/V of {cfg.n_layers} layers) "
          f"{t1 - t0:.3f} s, again {warm:.3f} s; decoder prompt of "
          f"{WHISPER_PROMPT} in {t2 - t1:.3f} s; {WHISPER_STEPS} greedy "
          f"steps in {dec_s:.3f} s ({B * WHISPER_STEPS / dec_s:.1f} tok/s, "
          f"{1e3 * dec_s / WHISPER_STEPS:.2f} ms a step); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
          f"{launches}")
    pos = positions[-1]
    with device_profile(cpu=True) as prof:
        t = time.perf_counter()
        step(params, cache, tok, pos)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    busy, n, by_name = device_time(prof)
    print(f"profile {cfg.name}: one decode step ({B} rows, {WHISPER_FRAMES}"
          f" encoder rows, profiler on): wall {wall * 1e3:.1f} ms, device "
          f"busy {busy / 1e3:.3f} ms ({busy / 1e4 / wall:.1f} %), {n} "
          "kernels")
    print_top(by_name)
    live = (None, torch.ones((B, WHISPER_FRAMES), dtype=torch.bool,
                             device=dev))
    q = torch.randn((B, cfg.n_kv_heads, 1, cfg.head_dim), generator=g,
                    device=dev).to(cfg.pdtype)

    def cross():
        for c in cache["dec_layers"]:
            flash_decode_gqa(q, None, None, c["xk"], c["xv"], pos,
                             scale=cfg.head_dim ** -0.5, softcap=0.0,
                             rows=live, update=False)

    cross_ms = sum(ms for ms, _ in kernels_ms(cross)[0].values())
    print("report " + json.dumps({
        "report": f"{cfg.name} serve, bf16, full width and depth",
        "requests": B, "frames": WHISPER_FRAMES,
        "prefill_s": t1 - t0, "prefill_again_s": warm,
        "decode_tok_s": B * WHISPER_STEPS / dec_s,
        "step_ms": 1e3 * dec_s / WHISPER_STEPS, "step_wall_ms": wall * 1e3,
        "step_busy_ms": busy / 1e3, "step_busy_share": busy / 1e6 / wall,
        "step_kernels": n, "cross_attention_device_ms": cross_ms,
        "cross_attention_share_of_busy": cross_ms / (busy / 1e3),
        "encoder_flash": {k: e[k] for e in entries
                          if e["name"] == "flash_attention_fwd_whisper"
                          for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms", "launches")},
        "card": CARD}))
    del params, cache, enc, frames
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, n_layers=2, n_enc_layers=2,
                                param_dtype="float32")
    params32 = _make_params(cfg32, dev)
    g = torch.Generator(device=dev).manual_seed(2)
    frames = torch.randn((2, WHISPER_FRAMES, cfg.d_model), generator=g,
                         device=dev) * 0.1
    toks = torch.randint(0, cfg.vocab, (2, 8), generator=g, device=dev)
    enc, cache = whisper_prefill(cfg32, params32, frames)
    ref = decode_hidden(cfg32, params32, toks, enc) @ \
        params32["embed"]["table"].T
    rel = 0.0
    for t in range(toks.shape[1]):
        got, cache = whisper_decode_step(cfg32, params32, cache, toks[:, t],
                                         positions[t][:2])
        rel = max(rel, float((got - ref[:, t]).abs().max() /
                             ref[:, t].abs().max()))
    check(rel < 1e-3, f"{cfg.name} full width f32, depth cut to 2 + 2: 8 "
          f"steps of whisper_decode_step ≡ decode_hidden over the same "
          f"tokens, relative max error {rel:.3g} (tol 1e-3)")
    del params32, cache, enc, frames
    torch.cuda.empty_cache()


def image_requests(cfg, params, dev, entries) -> None:
    """``INTERNVL2_IMAGES`` image requests: 256 patch positions (stub
    patch embeddings, seeded, × 0.1) and 16–512 text tokens (numpy seed 2),
    each ``prefill(frontend_embed)`` into the paged layout (pages of 16,
    :func:`pooled_rows`) and ``INTERNVL2_IMAGE_STEPS`` greedy
    ``decode_step``s through its page table. The counts are set to 0
    before the first and read after the last: the flash forward once a
    layer a prefill, paged GQA once a layer a step."""
    from repro_torch.serve.decode import decode_step
    from repro_torch.serve.prefill import prefill
    F, steps = cfg.frontend_tokens, INTERNVL2_IMAGE_STEPS
    rng = np.random.default_rng(2)
    text = rng.integers(16, 513, INTERNVL2_IMAGES)
    torch.cuda.synchronize()
    counters = _zero_counts()
    pre_s = dec_s = 0.0
    ok = True
    with plain_calls() as plain:
        for i, n in enumerate(text):
            S = F + int(n)
            toks = np.zeros((1, S), np.int32)     # pad ids under the patches
            toks[0, F:] = rng.integers(0, cfg.vocab, n)
            toks = torch.from_numpy(toks).to(dev)
            g = torch.Generator(device=dev).manual_seed(10 + i)
            fe = torch.randn((1, F, cfg.frontend_dim), generator=g,
                             device=dev) * 0.1
            torch.cuda.synchronize()
            t = time.perf_counter()
            logits, rows = prefill(cfg, params, toks, page_size=16,
                                   frontend_embed=fe)
            torch.cuda.synchronize()
            pre_s += time.perf_counter() - t
            cache, table = pooled_rows(cfg, rows, S, steps, dev)
            out = [logits.argmax(-1)]
            t = time.perf_counter()
            for j in range(steps):
                pos = torch.full((1,), S + j, dtype=torch.int32, device=dev)
                logits, cache = decode_step(cfg, params, cache, out[-1], pos,
                                            table)
                out.append(logits.argmax(-1))
            torch.cuda.synchronize()
            dec_s += time.perf_counter() - t
            out = torch.cat(out)
            ok &= bool(torch.isfinite(logits).all()) and \
                bool(((out >= 0) & (out < cfg.vocab)).all())
            del cache, rows
    launches = {n: getattr(mod, attr) for n, (mod, attr) in counters.items()}
    L = cfg.n_layers
    check(ok, f"{cfg.name} images: finite logits, {steps + 1} in-vocabulary "
          "tokens a request")
    check(launches["flash_attention_fwd"] == L * INTERNVL2_IMAGES and
          launches["paged_attention_gqa"] == L * steps * INTERNVL2_IMAGES
          and not plain, f"{cfg.name} images: the flash forward once a "
          f"layer a prefill and paged GQA once a layer a step ({launches}), "
          f"no plain version on the card ({dict(plain)})")
    _add_launches(entries, launches, f"{cfg.name} images",
                  ["flash_attention_fwd", "paged_attention_gqa"])
    print(f"serve {cfg.name} images: {INTERNVL2_IMAGES} requests of {F} "
          f"patch positions + {text.tolist()} text tokens: prefill "
          f"{pre_s:.3f} s ({int((F + text).sum()) / pre_s:.1f} prompt "
          f"tok/s), {steps} greedy decode steps each in {dec_s:.3f} s "
          f"({INTERNVL2_IMAGES * steps / dec_s:.1f} tok/s, one request at a "
          f"time); launches {launches}")


def internvl2_phase(dev, entries) -> None:
    """internvl2-26b at its published width and depth (48 layers, d 6144,
    48 heads over 8 of 128, SwiGLU 16384, vocab 92553, the 3200 → 6144
    front-end projection; 19.9 B params, 39.8 GB in bf16). Text traffic
    (the mistral workload's 12 lengths, internvl2's vocabulary) through the
    paged engine twice with graphs, a profiled quantum, once eagerly (the
    same streams); then :func:`image_requests`; prefill(S, fe) + paged
    decode against prefill(S + 1, fe) reported in bf16 and held at f32
    with depth cut to 2 layers (1e-3)."""
    from repro_torch.configs import get_config

    cfg = get_config("internvl2-26b")
    params = _make_params(cfg, dev)
    kw = dict(max_slots=8, max_len=4096, page_size=16, decode_quantum=8)
    eng = build_engine(cfg, params, device=dev, **kw)
    rng = np.random.default_rng(0)
    lens = rng.integers(16, 2001, 12)
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in lens]
    streams = serve_twice(eng, cfg, lens, prompts, 32,
                          ["flash_attention_fwd", "paged_attention_gqa"],
                          entries)
    profile_phase(eng, cfg)
    del eng
    torch.cuda.empty_cache()
    serve_eager(cfg, params, dev, lens, prompts, 32, streams, **kw)
    image_requests(cfg, params, dev, entries)
    S = cfg.frontend_tokens + 44
    g = torch.Generator(device=dev).manual_seed(3)
    fe = torch.randn((1, cfg.frontend_tokens, cfg.frontend_dim),
                     generator=g, device=dev) * 0.1
    rel = prefill_decode_rel(cfg, params, dev, S=S, frontend_embed=fe)
    print(f"{cfg.name} full width bf16, 48 layers: prefill(S, fe) + paged "
          f"decode vs prefill(S+1, fe), S {S}, relative max error {rel:.3g} "
          "(reported, not held: bf16 rounding through 48 random layers)")
    del params
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, n_layers=2, param_dtype="float32")
    params32 = _make_params(cfg32, dev)
    rel = prefill_decode_rel(cfg32, params32, dev, S=S, frontend_embed=fe)
    check(rel < 1e-3, f"{cfg.name} full width f32, depth cut to 2 layers: "
          f"prefill(S, fe) + paged decode ≡ prefill(S+1, fe), S {S}, "
          f"relative max error {rel:.3g} (tol 1e-3)")
    del params32
    torch.cuda.empty_cache()


# ------------------------------------------------------------ training
def plain_attend(q, k, v, *, scale, causal=True, window=0, softcap=0.0):
    """``models.attention.attend`` through the plain forward: autograd then
    differentiates the plain version (the f32 gradient check's reference)."""
    from repro_torch.kernels.flash_attention import ref
    B, Tq, Hkv, G, dh = q.shape
    out = ref.flash_attention_ref(
        q.reshape(B, Tq, Hkv * G, dh).permute(0, 2, 1, 3),
        k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3), scale=scale,
        causal=causal, window=window, softcap=softcap)
    return out.permute(0, 2, 1, 3).reshape(B, Tq, Hkv, G, v.shape[-1])


# Adam's first updates move every weight by ~lr, a d-wide product's output
# by ~lr·d: lr 1e-3 (the smoke size's) diverges at d >= 2048 in the JAX
# package and the port alike (tools/width_lr_probe.py), so the full width
# takes lr·d = 0.15, which learns at d = 3072
TRAIN_LR_D = 0.15
TRAIN_STEPS = 5
TRAIN_SEQ = 2048
TRAIN_KERNELS = ("flash_fwd", "bwd_d", "delta_kernel", "gg_", "ssd_",
                 "selective_scan", "sum_parts")


def _matrix_params(layer, cfg) -> float:
    """Matrix parameters a token passes through in one layer's spec tree:
    every product's weights (the MoE experts' top-k of E's share, shared
    experts whole), not the depthwise convs, norms or biases."""
    n_tok = 0.0
    for mod, leaves in layer.items():
        for name, spec in (leaves.items() if isinstance(leaves, dict)
                           else ()):
            if len(spec.shape) < 2 or name.startswith("conv"):
                continue
            n = math.prod(spec.shape)
            if mod == "moe" and name in ("w_up", "w_gate", "w_down"):
                n = n * cfg.moe.top_k / cfg.moe.n_experts
            n_tok += n
    return n_tok


def train_flops(cfg, B: int, S: int, frames: int = 0) -> float:
    """Model FLOPs of one step on B x S tokens: 6 per matrix parameter a
    token passes through (:func:`_matrix_params`, and the unembedding; the
    embedding is a lookup), plus the attention pairs (GQA 12·dh, MLA
    6·(dqk + dv) per live pair and head), the SSD products
    (``ssd_work``'s shared-score count) and the Mamba-1 scan
    (``scan_work``'s operations), each x3 for forward and backward; a front
    end's projection over its min(frontend_tokens, S // 2) positions. An
    encoder-decoder (S decoder tokens, ``frames`` encoder positions): the
    encoder's layers and each decoder layer's cross K/V projections per
    frame, the decoder's other products and the unembedding per decoder
    token, the encoder's B·H·frames² pairs, the decoder's causal pairs and
    B·H·S·frames cross pairs. The layer recompute is not counted."""
    from repro_torch.models.transformer import block_cfgs
    from repro_torch.params import param_specs
    specs = param_specs(cfg)
    if cfg.enc_dec:
        dec = _matrix_params(specs["dec_layers"][0], cfg)
        cross_kv = sum(math.prod(specs["dec_layers"][0]["cross"][w].shape)
                       for w in ("wk", "wv"))
        per_frame = cfg.n_enc_layers * _matrix_params(
            specs["enc_layers"][0], cfg) + cfg.n_layers * cross_kv
        per_token = cfg.vocab * cfg.d_model + cfg.n_layers * (dec - cross_kv)
        pairs = cfg.n_heads * B * (
            cfg.n_enc_layers * frames * frames
            + cfg.n_layers * (_causal_pairs(S, 0) + S * frames))
        return 6 * (per_frame * B * frames + per_token * B * S) + \
            12 * cfg.head_dim * pairs
    per_token = cfg.vocab * cfg.d_model + sum(
        _matrix_params(layer, cfg) for layer in specs["layers"])
    flops = 6 * per_token * B * S
    if cfg.frontend != "none":
        flops += 6 * cfg.frontend_dim * cfg.d_model * B * min(
            cfg.frontend_tokens, S // 2)
    pairs = _causal_pairs(S, 0) * B * cfg.n_heads
    for bc in block_cfgs(cfg):
        if bc.mixer == "attn" and cfg.mla:
            m = cfg.mla
            flops += 6 * (m.nope_dim + m.rope_dim + m.v_dim) * pairs
        elif bc.mixer == "attn":
            flops += 12 * cfg.head_dim * pairs
        elif cfg.ssm.version == 1:
            flops += 3 * scan_work(B, S, cfg.d_inner, cfg.ssm.d_state)["ops"]
        else:
            s = cfg.ssm
            Q = min(s.chunk, S)
            flops += 3 * ssd_work(B * S // Q, Q, s.head_dim, s.d_state,
                                  cfg.d_inner // s.head_dim)["shared_ops"]
    return flops


@contextmanager
def plain_versions():
    """``models.attention.attend``, the MoE experts' grouped GEMM,
    ``ssd_scan``'s intra-chunk op and the Mamba-1 selective scan swapped
    for their plain versions, which autograd then differentiates (the f32
    gradient checks' reference)."""
    from repro_torch.kernels.grouped_gemm import ref as gg_ref
    from repro_torch.kernels.selective_scan import ops as scan_ops
    from repro_torch.kernels.selective_scan import ref as scan_ref
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd import ref as ssd_ref
    from repro_torch.models import attention, moe
    kernels = (attention.attend, moe.grouped_gemm_autograd,
               ssd_ops.intra_chunk_autograd, scan_ops.selective_scan)
    attention.attend = plain_attend
    moe.grouped_gemm_autograd = gg_ref.grouped_gemm_ref
    ssd_ops.intra_chunk_autograd = ssd_ref.ssd_intra_chunk_ref
    scan_ops.selective_scan = scan_ref.selective_scan_ref
    try:
        yield
    finally:
        (attention.attend, moe.grouped_gemm_autograd,
         ssd_ops.intra_chunk_autograd, scan_ops.selective_scan) = kernels


def whisper_frames(n: int):
    """A batch's ``extra`` for whisper: n stub frames (B, n, d) of
    N(0, 0.1²) a row (JAX ``synth_batch``'s), made on the card."""
    def add(cfg, batch, g):
        batch["frames"] = torch.randn(
            (batch["tokens"].shape[0], n, cfg.d_model), generator=g,
            device=g.device) * 0.1
        return batch
    return add


def vlm_patches(cfg, batch, g):
    """A batch's ``extra`` for a front end: min(frontend_tokens, S // 2)
    embeddings (B, ft, frontend_dim) of N(0, 0.1²) made on the card, the
    mask zero on their positions (JAX ``synth_batch``'s)."""
    B, S = batch["tokens"].shape
    ft = min(cfg.frontend_tokens, S // 2)
    batch["frontend_embed"] = torch.randn(
        (B, ft, cfg.frontend_dim), generator=g, device=g.device) * 0.1
    batch["mask"] = batch["mask"].clone()
    batch["mask"][:, :ft] = 0.0
    return batch


def train_cell(dev, entries, cfg, where: str, path, *, B: int,
               moments: str = "float32", check_layers: int,
               check_tokens: int, seq: int = TRAIN_SEQ, extra=None,
               check_extra=None, check_over=None,
               lr_d: float = TRAIN_LR_D, steps: int = TRAIN_STEPS) -> None:
    """``cfg`` (published width, its depth as given) with seeded random
    weights made on the card: ``steps`` steps of ``make_train_step``
    (AdamW lr ``lr_d``/d, warmup 2, cosine to the last step, ``moments``) on
    batch B x ``seq`` of ``SyntheticLM(V, seq, seed=0)`` through
    ``PrefetchLoader`` (``extra(cfg, batch, generator)`` adds what the loss
    wants beyond tokens: whisper's frames, a front end's embeddings), the
    launch counts set to 0 just before those steps and read just after
    (added to ``entries`` under ``where``; every kernel of ``path``
    launched), then one profiled step. Held: every loss finite, the first
    within 0.5 of ln V + 0.02²·d/2 (random logits of variance 0.02²·d)
    plus the first step's ``moe_aux``, the mean of the last two below the
    first. Then the f32 gradient check at full width, depth
    ``check_layers`` (and ``check_over``'s other fields), batch 1 x
    ``check_tokens`` (and ``check_extra``): every leaf through the kernels
    (kept on the host, compared on the card) within 1e-3 of its largest
    value of autograd through the plain versions
    (:func:`plain_versions`)."""
    from repro_torch.data.loader import PrefetchLoader
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.kernels import _build
    from repro_torch.models.model import loss_fn
    from repro_torch.params import init_params, n_params, tree_leaves
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.step import init_state, make_train_step

    S = seq
    frames = 0
    ocfg = OptConfig(lr=lr_d / cfg.d_model, warmup_steps=2,
                     decay_steps=steps, moments_dtype=moments)
    t0 = time.perf_counter()
    state = init_state(cfg, seed=0, ocfg=ocfg, device=dev)
    torch.cuda.synchronize()
    P = n_params(cfg)
    print(f"train {cfg.name} ({where}), depth {cfg.n_layers}, lr "
          f"{ocfg.lr:.3g}: {P / 1e9:.3f} B params and {moments} moments made "
          f"on the card in "
          f"{time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    loader = PrefetchLoader(SyntheticLM(cfg.vocab, S, seed=0).iterator(B),
                            device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    def next_batch():
        batch = next(loader)
        return extra(cfg, batch, gen) if extra else batch

    if cfg.enc_dec:
        frames = next_batch()["frames"].shape[1]
    step_fn = make_train_step(cfg, ocfg)
    flops = train_flops(cfg, B, S, frames)
    peak_ops = PEAK_OPS_PER_S[torch.bfloat16]
    counters = _zero_counts()
    torch.cuda.reset_peak_memory_stats()
    losses, auxes, times = [], [], []
    try:
        for i in range(steps):
            batch = next_batch()
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, m = step_fn(state, batch)
            loss, gn = float(m["loss"]), float(m["grad_norm"])
            torch.cuda.synchronize()
            dt = time.perf_counter() - t
            losses.append(loss)
            auxes.append(float(m.get("moe_aux", 0.0)))
            times.append(dt)
            print(f"  step {i + 1}: loss {loss:.4f}"
                  + (f" (moe_aux {auxes[-1]:.5f})" if "moe_aux" in m else "")
                  + f", grad norm {gn:.4f}, lr {m['lr']:.2e}, {dt:.3f} s, "
                  f"{B * S / dt:.0f} tokens/s"
                  + (f" ({B * frames / dt:.0f} frames/s)" if frames else "")
                  + f", {flops / dt / 1e12:.1f} "
                  f"TFLOP/s (model FLOPs), {100 * flops / dt / peak_ops:.1f} "
                  "% of 989 TFLOP/s")
        launches = {n: getattr(mod, attr)
                    for n, (mod, attr) in counters.items()}
        peak = torch.cuda.max_memory_allocated() / 2**30
        steady = sum(times[1:]) / (steps - 1)
        print(f"train {where}: peak memory {peak:.2f} GiB; steps 2-{steps} "
              f"mean {steady:.3f} s, {B * S / steady:.0f} tokens/s"
              + (f" ({B * frames / steady:.0f} frames/s)" if frames else "")
              + ", model "
              f"FLOP/s {100 * flops / steady / peak_ops:.1f} % of the bf16 "
              f"peak ({flops / 1e12:.2f} TFLOP a step); launches {launches}")
        with device_profile(cpu=True) as prof:
            batch = next_batch()
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, m = step_fn(state, batch)
            float(m["loss"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
    finally:
        loader.close()
    busy, n, by_name = device_time(prof)
    print(f"profile: one {where} step (profiler on): wall {wall:.3f} s, "
          f"device busy {busy / 1e6:.3f} s ({busy / 1e4 / wall:.1f} %), {n} "
          "kernels")
    print_top(by_name)
    print(f"  hand-written kernels of the {where} step: " + ", ".join(
        f"{_build.kernel_label(name)} {us / 1e3:.3f} ms ({k}x)"
        for name, (us, k) in sorted(by_name.items())
        if any(s in name for s in TRAIN_KERNELS)))
    first = math.log(cfg.vocab) + 0.02 ** 2 * cfg.d_model / 2 + auxes[0]
    check(all(math.isfinite(x) for x in losses), f"train {where}: every "
          f"loss is finite {[round(x, 4) for x in losses]}")
    check(abs(losses[0] - first) < 0.5, f"train {where}: first loss "
          f"{losses[0]:.4f} within 0.5 of ln V + 0.02²·d/2 + moe_aux = "
          f"{first:.4f} (random logits of variance 0.02²·d)")
    check(sum(losses[-2:]) / 2 < losses[0], f"train {where}: the mean of "
          f"the last two losses {sum(losses[-2:]) / 2:.4f} is below the "
          "first")
    _add_launches(entries, launches, where, path)
    del state, m, batch, prof
    torch.cuda.empty_cache()
    t_check = time.perf_counter()
    print(f"train {where}: steps and profile {t_check - t0:.1f} s")

    cfg32 = dataclasses.replace(cfg, n_layers=check_layers,
                                param_dtype="float32", **(check_over or {}))
    params = init_params(cfg32, seed=0, device=dev)
    leaves = [p.requires_grad_() for p in tree_leaves(params)]
    g = torch.Generator(device=dev).manual_seed(0)
    toks = torch.randint(0, cfg32.vocab, (1, check_tokens + 1), generator=g,
                         device=dev)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:],
             "mask": torch.ones((1, check_tokens), device=dev)}
    if check_extra:
        batch = check_extra(cfg32, batch, g)
    grads = [x.cpu() for x in torch.autograd.grad(
        loss_fn(cfg32, params, batch)[0], leaves)]
    with plain_versions():
        want = torch.autograd.grad(loss_fn(cfg32, params, batch)[0], leaves)
    rel, finite = 0.0, True
    for a, b in zip(grads, want):
        a = a.to(b.device)       # the host's passes took ~1 min a check
        finite &= bool(torch.isfinite(a).all() and torch.isfinite(b).all())
        rel = max(rel, float((a - b).abs().max() / b.abs().max()))
    more = sorted(set(batch) - {"tokens", "targets", "mask"})
    check(finite and rel < 1e-3, f"train {where} f32 at full width, depth "
          f"{check_layers} {check_over or ''}, batch 1 x {check_tokens}"
          f"{f' and {more}' if more else ''}: every gradient leaf "
          f"finite ({finite}) and through the kernels within {rel:.3g} of "
          "its largest value of autograd through the plain versions (tol "
          f"1e-3); the check took {time.perf_counter() - t_check:.1f} s")
    del params, leaves, grads, want
    torch.cuda.empty_cache()


def train_phase(dev, entries) -> None:
    """mistral-nemo-12b at its published width (d 5120, 32 heads over 8 of
    128, FFN 14336, V 131072), depth cut 40 → 8 layers (3.52 B params: bf16
    params and grads, f32 m and v, 42 GB), batch 4 x 2048; the f32 check at
    depth 2, batch 1 x 512 (:func:`train_cell`)."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("mistral-nemo-12b"), n_layers=8)
    train_cell(dev, entries, cfg, "train",
               ("flash_attention_fwd_lse", "flash_attention_bwd"), B=4,
               check_layers=2, check_tokens=512)


def train_moe_phase(dev, entries) -> None:
    """phi3.5-moe-42b at its published width (d 4096, 32 heads over 8 of
    128, 16 experts of 6400, top-2, V 32064), depth cut 32 → 3 layers
    (4.164 B params: bf16 params and grads, f32 m and v, 46.5 GiB), batch
    4 x 2048 (expert capacity 1280); the f32 check at depth 2, batch
    1 x 512."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("phi3.5-moe-42b-a6.6b"), n_layers=3)
    train_cell(dev, entries, cfg, "train-moe",
               ("flash_attention_fwd_lse", "flash_attention_bwd",
                "grouped_gemm"), B=4, check_layers=2, check_tokens=512)


def train_mla_phase(dev, entries) -> None:
    """deepseek-v2-236b at its published width (d 5120, MLA with 128 heads
    at (192, 128), V 102400), depth cut 60 → 2 layers: the dense first
    layer (FFN 12288) and one MoE layer (160 experts of 1536, top-6, 2
    shared); 5.359 B params, int8 moments (29.9 GiB of state; f32 moments
    would take 59.9 GiB), batch 4 x 2048 (expert capacity 384); the f32
    check at depth 2, batch 1 x 256."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("deepseek-v2-236b"), n_layers=2)
    train_cell(dev, entries, cfg, "train-mla",
               ("flash_attention_fwd_lse_mla", "flash_attention_bwd_mla",
                "grouped_gemm"), B=4, moments="int8", check_layers=2,
               check_tokens=256)


def train_ssm_phase(dev, entries) -> None:
    """mamba2-130m at its published width and depth (24 SSD layers, d 768,
    24 heads of 64, state 128, chunk 256; 0.129 B params, f32 moments),
    batch 8 x 2048 (64 chunk rows a layer); the f32 check at full depth,
    batch 1 x 512."""
    from repro_torch.configs import get_config
    cfg = get_config("mamba2-130m")
    train_cell(dev, entries, cfg, "train-ssm", ("ssd_intra_chunk",), B=8,
               check_layers=cfg.n_layers, check_tokens=512)


def train_hybrid_phase(dev, entries) -> None:
    """jamba-v0.1-52b at its published width (d 4096, Mamba-1 with d_inner
    8192 and state 16, attention at slot 4 of a period of 8 (32 heads over
    8 of 128), 16 experts of 14336 top-2 on odd slots, dense FFNs of 14336
    on even ones, V 65536), depth cut 32 → 5 layers, slots 0-4: Mamba +
    dense, Mamba + MoE, Mamba + dense, Mamba + MoE, attention + dense, so
    that every layer kind of the period trains (7.166 B params, int8
    moments), batch 2 x 2048 (expert capacity 640); the f32 check at depth
    2 (Mamba + dense, Mamba + MoE), batch 1 x 512."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("jamba-v0.1-52b"), n_layers=5)
    train_cell(dev, entries, cfg, "train-hybrid",
               ("selective_scan", "selective_scan_bwd",
                "flash_attention_fwd_lse", "flash_attention_bwd",
                "grouped_gemm"), B=2, moments="int8", check_layers=2,
               check_tokens=512)


def train_encdec_phase(dev, entries) -> None:
    """whisper-large-v3 at its published width and depth (32 encoder and 32
    decoder layers, d 1280, 20 heads of 64, FFN 5120, V 51866; 1.535 B
    params, f32 moments): batch 8 of 1500 stub frames and 448 decoder
    tokens of ``SyntheticLM``; the f32 check at 2 + 2 layers, 1 x 512
    frames and 64 decoder tokens. The flash kernels run at G 1, dh 64:
    non-causal in the encoder and the cross attention, causal in the
    decoder. lr·d is a quarter of the other cells' (lr 2.93e-5, the
    mistral cell's own): the 64-layer stack at lr·d 0.15 (1.17e-4) rose
    after the warmup (loss 11.06 → 13.12, grad norm 74 → 285)."""
    from repro_torch.configs import get_config
    cfg = get_config("whisper-large-v3")
    train_cell(dev, entries, cfg, "train-encdec",
               ("flash_attention_fwd_lse_whisper",
                "flash_attention_bwd_whisper"), B=8, seq=cfg.max_decoder_len,
               extra=whisper_frames(1500), check_layers=2, check_tokens=64,
               check_extra=whisper_frames(512),
               check_over=dict(n_enc_layers=2), lr_d=TRAIN_LR_D / 4)


def train_vlm_phase(dev, entries) -> None:
    """internvl2-26b at its published width (d 6144, 48 heads over 8 of
    128, FFN 16384, V 92553, the 3200 → 6144 front-end projection), depth
    cut 48 → 8 layers (4.278 B params, f32 moments), batch 4 x 2048 with
    256 front-end positions of 3200-wide embeddings a row and the mask zero
    there; the f32 check at depth 2, batch 1 x 512 with its 256 front-end
    positions."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("internvl2-26b"), n_layers=8)
    train_cell(dev, entries, cfg, "train-vlm",
               ("flash_attention_fwd_lse", "flash_attention_bwd"), B=4,
               extra=vlm_patches, check_layers=2, check_tokens=512,
               check_extra=vlm_patches)


def launcher_phase() -> None:
    """The training launcher at smoke size, each run in its own process,
    the two at once: mistral-nemo-12b and phi3.5-moe-42b."""
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    t = time.perf_counter()
    runs = []
    for arch in ("mistral-nemo-12b", "phi3.5-moe-42b-a6.6b"):
        cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
               arch, "--steps", "3"]
        runs.append((cmd, subprocess.Popen(
            cmd, cwd=root, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)))
    try:
        for cmd, proc in runs:
            out, err = proc.communicate(timeout=600)
            print(out[-2000:] + err[-2000:])
            check(proc.returncode == 0 and "done: 3 steps" in out,
                  f"launcher {' '.join(cmd[1:])} exits {proc.returncode} "
                  f"at {time.perf_counter() - t:.1f} s")
    finally:
        for _, proc in runs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    global CARD
    CARD = smi
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    built = _build.build()
    print(f"kernels built in {built:.1f} s")
    for name in _build.NAMES:
        log = _build.library_path(name).with_suffix(".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  {name}: {line.strip()}")
    def timed(fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        print(f"phase {fn.__name__}: {time.perf_counter() - t:.1f} s",
              flush=True)
        return out

    sass = timed(sass_phase)
    entries = [timed(paged_phase, dev), timed(paged256_phase, dev),
               timed(flash_phase, dev), timed(flash256_phase, dev),
               timed(flash80_phase, dev), timed(flash_whisper_phase, dev),
               *timed(flash_bwd_phase, dev),
               *timed(flash_mla_train_phase, dev)]
    whisper_flash, g6 = timed(flash_train_shapes_phase, dev)
    for e in entries:
        key = {"flash_attention_bwd": "bwd",
               "flash_attention_fwd_lse": "fwd_lse"}.get(e["name"])
        if key:
            e["g6"] = {"shape": g6["shape"], "routes": g6["routes"],
                       **g6[key]}
            e["max_abs_err"] = max(e["max_abs_err"], g6[
                "err_bwd" if key == "bwd" else "err_lse"])
    entries += [*whisper_flash, timed(mla_phase, dev), timed(gg_phase, dev),
                timed(gemm_phase, dev), timed(ssd_phase, dev),
                timed(selective_scan_phase, dev),
                timed(scan_backward_phase, dev)]
    for e in entries:
        if e["name"] in sass:
            e["sass"] = sass[e["name"]]
    timed(paged256_f32_report, dev)
    torch.cuda.empty_cache()
    for phase in (hbb_phase, serve_phase, sharded_phase, deepseek_phase,
                  mamba_phase,
                  jamba_phase, jamba_spec_phase, nemotron_phase,
                  gemma2_phase, danube_phase, gather_phase, whisper_phase,
                  internvl2_phase, train_phase, train_moe_phase,
                  train_mla_phase, train_ssm_phase, train_hybrid_phase,
                  train_encdec_phase, train_vlm_phase, variants_phase):
        timed(phase, dev, entries)
    print(f"memory: {len(MEMORY_SEEN)} engine layouts held to the memory "
          "helpers")
    timed(launcher_phase)
    keys = ("name", "route", "source", "replaces", "launches",
            "launches_by_path", "max_abs_err", "tol", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "check")
    print(json.dumps({"kernels": [
        {k: e[k] for k in keys + tuple(x for x in (
            "passes_ms", "mla", "decode", "backward", "chunks", "n4096",
            "paged", "jamba", "scan", "scan_bwd", "g6", "shapes",
            "ssd", "sass", "sdpa_gathered_ms", "verify_rows_err",
            "kernel_route", "shards_in_turn")
            if x in e)}
        for e in entries]}))
    print(smi)
    print(f"profiles whose lead-in kernels the profiler lost: "
          f"{LEAD_INS['lost']} of {LEAD_INS['profiles']}")
    print(f"total {time.perf_counter() - t0:.1f} s")
    if FAILURES:
        print(f"{len(FAILURES)} check(s) failed: {FAILURES}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
