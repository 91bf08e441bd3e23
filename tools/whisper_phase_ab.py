#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s whisper phase from one tree of the repo on the card.

    python3 tools/whisper_phase_ab.py TREE

Takes ``chip_smoke.py`` and ``repro_torch`` from ``TREE`` (a checkout, or a
``git archive`` of the parent, say), builds its flash kernel and runs
``whisper_phase``: whisper-large-v3 at full width and depth, prefill, 124
greedy decode steps (ms a step, tok/s), one profiled step (busy share,
kernels) and the f32 check. Prints the checks that failed last. Compare two
trees in one call, one process each, in turns: parent, change, change,
parent.
"""
import os
import sys

tree = os.path.abspath(sys.argv[1])
sys.path[:0] = [tree, os.path.join(tree, "src")]
os.chdir(tree)
import torch  # noqa: E402
import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
print(tree, f"built in {_build.build(('flash_attention',)):.1f} s")
cs.whisper_phase(torch.device("cuda"), [])
print("failed checks:", cs.FAILURES)
