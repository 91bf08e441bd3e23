"""One intra-op thread in each test process for the port's CPU tests.

The tier-1 command runs six xdist workers on the host's cores, and every
worker imports every test module when it collects, so this setting holds
in each worker before any test runs. PyTorch's default, one OpenMP
thread a core in every process, oversubscribes the cores six times over,
and a parallel region waits for its slowest thread: four concurrent runs
of ``test_torch_train_hybrid.py::test_jamba_train_steps_match_jax`` on 8
cores took 262 s each with the default and 71 s with one thread. The
port's results change only in the order of a reduction's sums. The JAX
tests do not use PyTorch. This module holds no test."""
import torch

torch.set_num_threads(1)
