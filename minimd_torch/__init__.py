"""minimd_torch: the PyTorch/CUDA port of miniMD-TPU for NVIDIA Hopper.

Public API:

    from minimd_torch import Simulation, builtin_deck, parse_deck

    sim = Simulation.from_input(builtin_deck("lj"), device="cuda")
    trace = sim.run()                    # (ntimes, 3) T/U/P per step
    rows = sim.thermo_trace(trace)       # thermo-cadence rows incl. step 0

The package imports neither jax nor the JAX package minimd_tpu: it keeps
its own copies of the host modules it needs (config, units, create, rng,
lammps_data, eam_file, validate, timer).
"""

from .config import In, builtin_deck, parse_deck  # noqa: F401

__version__ = "0.1.0"


def __getattr__(name):
    # Lazy: importing Simulation pulls in torch; keep bare
    # `import minimd_torch` cheap for tooling.
    if name == "Simulation":
        from .sim import Simulation
        return Simulation
    raise AttributeError(name)
