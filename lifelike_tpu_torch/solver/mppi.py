"""MPPI configuration (port of lifelike_tpu.solver.mppi.MPPIConfig)."""
from typing import NamedTuple


class MPPIConfig(NamedTuple):
    horizon: int = 50
    population: int = 4096
    iterations: int = 1
    sigma: float = 0.08  # rad, exploration std on joint-target deltas
    beta: float = 0.7  # AR(1) smoothing of noise along the horizon
    temperature: float = 0.05
    elite_frac: float = 0.0  # optional CEM-style truncation; 0 = pure MPPI
