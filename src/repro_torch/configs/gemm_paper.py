"""The paper's own benchmark configuration (HIP3ES 2018, Tables 1/2, §4-5;
copy of ``repro/configs/gemm_paper.py``).

GEMM with the Fig. 4 tiling, 1M-element matrices (1024×1024) for the main
experiment and 16M (4096×4096) for the scaling study. "Buffered columns"
(32 on Zynq Z7020, 128 on ZynqUS+ ZU9) is the on-chip-capacity knob — on
the card it is the ``bn`` tile of ``kernels/gemm``, bounded by shared
memory (``kernels/gemm/ops.py::smem_bytes``).

Platform constants (Table 1) are kept for the energy model of Fig. 6.
"""
from dataclasses import dataclass


@dataclass(frozen=True)
class Platform:
    name: str
    n_cpu_cores: int
    n_fpga_units: int
    cpu_freq_mhz: float
    power_budget_w: float        # measured peak in the paper (§5)
    rel_fpga_speed: float        # calibrated f (FPGA CU vs one CPU core)
    buffered_columns: int        # Table 2 capacity knob


# Paper Table 1 + §5 measurements. rel_fpga_speed is calibrated so the
# heterogeneous time reduction ncc/(f·nfc + ncc) lands in the paper's §6
# 25–50 % band: Zynq 2/(4+2) = 33 %, ZynqUS+ 4/(2.5·4+4) = 28.6 %.
ZYNQ_7020 = Platform("zynq-z7020", n_cpu_cores=2, n_fpga_units=1,
                     cpu_freq_mhz=600.0, power_budget_w=0.8,
                     rel_fpga_speed=4.0, buffered_columns=32)
ZYNQ_ULTRA_ZU9 = Platform("zynq-ultrascale-zu9", n_cpu_cores=4, n_fpga_units=4,
                          cpu_freq_mhz=1400.0, power_budget_w=4.2,
                          rel_fpga_speed=2.5, buffered_columns=128)

PLATFORMS = {p.name: p for p in (ZYNQ_7020, ZYNQ_ULTRA_ZU9)}

# Main experiment: 1M elements; scaling study: 16M elements (paper §5).
GEMM_N_MAIN = 1024
GEMM_N_SCALING = 4096
# FPGA chunk sizes swept on the X axis of Fig. 5 (rows of C per chunk).
FPGA_CHUNK_SWEEP = (8, 16, 32, 64, 128, 256)
