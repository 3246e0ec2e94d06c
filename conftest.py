"""Work units for `pytest -n N --dist loadfile` (pytest-xdist).

`--dist loadfile` hands each test file whole to one worker. Two files of the
JAX package's tests are far heavier than the rest: `tests/test_multichip.py`
(sharded runs on the 8-device CPU mesh, ~1450 s of junit time in a whole
run on an 8-core host with 6 workers) and `tests/test_lj_trace.py` (~775 s),
of ~5200 s in all, so one worker ran the first for the whole run. This
scheduler cuts both files into units of one to six tests by theme, without
moving a test, and xdist hands the units out as it hands out files. Tests
that share a module fixture stay in one unit; tests the table does not name
stay in their file's unit. Such a run keeps the host's cores busy, so a
schedule that starts the sharded units at once is slower: handing them out
heaviest first took 1243-1323 s where xdist's order took 1142-1167 s.
"""

import pytest

# file -> the units cut out of it, each a tuple of test functions.
CUTS = {
    "tests/test_multichip.py": (
        # ShardedSimulation's API against Simulation
        ("test_sharded_simulation_api",
         "test_sharded_datafile_init",
         "test_sharded_nstat0_start_end_rows",
         "test_per_device_statistics_swap_sizes",
         "test_sharded_custom_potential_and_cell_chunk_guard"),
        # run_timed on the global thermo cadence and across a regrow
        ("test_sharded_run_timed_global_thermo_cadence",
         "test_sharded_run_timed_survives_regrow"),
        # grow-and-replay after a cell or migration-buffer overflow
        ("test_sharded_overflow_grow_and_replay",
         "test_sharded_migration_buffer_grow_and_replay"),
        # multi-hop halos and migration
        ("test_multihop_halo_force_matches_single_device",
         "test_multihop_migration_places_teleported_atoms"),
        # the h=2 EAM slabs: 158-433 s in seven runs, by what ran beside it
        ("test_sharded_eam_h2_thick_slab_halo",),
        # the Pallas pair kernels inside shard_map
        ("test_sharded_pallas_backend_matches_xla",
         "test_sharded_pallas_mixed_axis_meshes"),
        # per-type tables and the half-neighbor paths
        ("test_sharded_per_type_params_matches_single_device",
         "test_sharded_half_neighbor_matches_full"),
    ),
    "tests/test_lj_trace.py": (
        # the golden 4k trace and the half-neighbor paths
        ("test_step0_exact",
         "test_overflow_free",
         "test_lj_4k_trace_statistical",
         "test_lj_f32_no_overflow",
         "test_half_neighbor_matches_full",
         "test_half_neighbor_gn0_matches_full"),
        # capacity regrow
        ("test_capacity_regrow_preserves_physics",
         "test_capacity_regrow_retune_recovers_all_atoms",
         "test_run_timed_overflow_grow_and_continue"),
        # variants of the run() loop
        ("test_triple_carry_bit_identical",
         "test_w_carry_drift_bounded",
         "test_run_timed_matches_run_program"),
    ),
}

# (file, test function) -> the scope of the unit it is cut into
SCOPE = {(path, name): f"{path}::{unit[0]}"
         for path, units in CUTS.items() for unit in units for name in unit}


@pytest.hookimpl(optionalhook=True)
def pytest_xdist_make_scheduler(config, log):
    if config.getvalue("dist") != "loadfile":
        return None
    from xdist.scheduler import LoadFileScheduling

    class CutFileScheduling(LoadFileScheduling):
        def _split_scope(self, nodeid):
            path, _, name = nodeid.partition("::")
            return SCOPE.get((path, name.split("[", 1)[0]), path)

    return CutFileScheduling(config, log)
