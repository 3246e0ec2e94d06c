"""minimd_torch: the PyTorch/CUDA port of miniMD-TPU for NVIDIA Hopper.

Public API:

    from minimd_torch import Simulation, builtin_deck, parse_deck

    sim = Simulation.from_input(builtin_deck("lj"), device="cuda")
    trace = sim.run()                    # (ntimes, 3) T/U/P per step
    rows = sim.thermo_trace(trace)       # thermo-cadence rows incl. step 0

The package never imports jax. It shares the jax-free host modules of
minimd_tpu (deck parser, units, setup, rng, native, validate, timer).
"""

from minimd_tpu.config import In, builtin_deck, parse_deck  # noqa: F401

__version__ = "0.1.0"


def __getattr__(name):
    # Lazy: importing Simulation pulls in torch; keep bare
    # `import minimd_torch` cheap for tooling.
    if name == "Simulation":
        from .sim import Simulation
        return Simulation
    raise AttributeError(name)
