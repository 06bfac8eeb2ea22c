"""The port's chaos harness (``repro_torch.ft.chaos``) against the JAX
package's: one seed of the whole matrix (push, fan-out, relay, follower
and bundle scenarios under drop, corrupt, delay, crash and bitrot) gives
each cell the same verdict, the same number of fault events and the same
retries; the seed grammar and the repro line are the reference's, with the
port's module named.

A corrupt fault flips the byte at a position hashed from the seed, the
point and the hit's key, and keys hold the stores' paths: so the two
harnesses run in the same directories, one after the other. Under other
directories a count may differ with no fault of either package (the
bundle/corrupt cell counts 9 events where the follower's fetch flips back
the byte the publisher flipped in the index, about one directory name in
a thousand, 5 elsewhere; ``test_bundle_corrupt_count_follows_the_paths``).
"""
import dataclasses
import shutil

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
    got = cells(TC, tmp_path / "run")
    shutil.rmtree(tmp_path / "run")
    assert got == cells(JC, tmp_path / "run")
    assert len(got) == 25 and all(ok and fired >= 1
                                  for *_, ok, fired, _ in got)


def _index_flips_cancel(faults, root: str, size: int) -> bool:
    """Whether the publisher's flip of the index (``size`` bytes) at
    registry ``root`` and the follower's flip of its fetch hit one byte."""
    key = f"{root}:ckpt:index"
    return len({int(faults._unit(0, point, key, 0) * size) % size
                for point in ("bundle.publish", "bundle.fetch")}) == 1


def test_bundle_corrupt_count_follows_the_paths(tmp_path, monkeypatch):
    """Seed 0's bundle/corrupt cell counts 5 fault events in both packages
    (4 flips as the publisher writes, the index's when the follower
    reads it, which then pulls from the remote), and 9 in both where the
    index's two flips fall on one byte (the index reads clean, and the
    follower tries each corrupt bundle chain first)."""
    import repro.ft.faults as JF
    sizes = []
    hit = JF.FaultInjector.hit

    def spy(self, point, key, data):
        if point == "bundle.publish" and key.endswith(":index"):
            sizes.append(len(data))
        return hit(self, point, key, data)

    monkeypatch.setattr(JF.FaultInjector, "hit", spy)
    names = [f"c{i}" for i in range(20000)]
    JC.run_cell("bundle", "corrupt", seed=0, base_dir=tmp_path / "probe")
    size, = set(sizes)
    cancel = [n for n in names if _index_flips_cancel(
        JF, str(tmp_path / n / "registry"), size)]
    plain = [n for n in names if not _index_flips_cancel(
        JF, str(tmp_path / n / "registry"), size)]
    assert cancel, "no directory name cancels the flips"
    for name, want in ((cancel[0], 9), (plain[0], 5)):
        for mod in (JC, TC):
            cell = mod.run_cell("bundle", "corrupt", seed=0,
                                base_dir=tmp_path / name)
            shutil.rmtree(tmp_path / name)
            assert (cell.ok, cell.fired) == (True, want), (mod, name)


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
