"""The port's chaos harness (``repro_torch.ft.chaos``) against the JAX
package's: one seed of the whole matrix (push, fan-out, relay, follower
and bundle scenarios under drop, corrupt, delay, crash and bitrot) gives
each cell the same verdict, the same number of fault events and the same
retries; the seed grammar and the repro line are the reference's, with the
port's module named."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
# small shapes: one thread each, so the suite's parallel workers do not
# oversubscribe the cores that timing-sensitive tests share with them
torch.set_num_threads(1)

import repro.ft.chaos as JC  # noqa: E402
import repro_torch.ft.chaos as TC  # noqa: E402


def cells(mod, tmp_path):
    out = []
    for scenario in mod.SCENARIOS:
        for mode in mod.MODES:
            c = mod.run_cell(scenario, mode, seed=0,
                             base_dir=tmp_path / f"{scenario}-{mode}")
            out.append((c.scenario, c.mode, c.seed, c.ok, c.fired,
                        c.retries_spent))
    return out


def test_one_seed_matrix_matches_the_references(tmp_path):
    assert (TC.MODES, TC.SCENARIOS, TC.SEAMS) == \
        (JC.MODES, JC.SCENARIOS, JC.SEAMS)
    got = cells(TC, tmp_path / "torch")
    assert got == cells(JC, tmp_path / "jax")
    assert len(got) == 25 and all(ok and fired >= 1
                                  for *_, ok, fired, _ in got)


@pytest.mark.parametrize("spec", ["3", "2:9", "1:12:3", "0::4", "3::4",
                                  ":5", "4:"])
def test_parse_seeds_is_the_references(spec):
    assert list(TC.parse_seeds(spec)) == list(JC.parse_seeds(spec))


def test_chaos_cell_repro_names_the_port():
    cell = TC.ChaosCell("relay", "corrupt", 7)
    ref = JC.ChaosCell("relay", "corrupt", 7)
    assert dataclasses.asdict(cell) == dataclasses.asdict(ref)
    assert cell.repro == ref.repro.replace("repro.ft.chaos",
                                           "repro_torch.ft.chaos")
    assert "python -m repro_torch.ft.chaos --seeds 7" in cell.repro
