"""legacy-train over two epochs in both packages' CLIs, on
test_torch_legacy's world (a file of its own, so that a parallel run
spreads the two files' CLI runs over two workers)."""
from nanosnp_tpu.runtime.cli import main as jax_cli
from nanosnp_tpu_torch.runtime.cli import main as torch_cli

from test_torch_legacy import _world_args, jax_params, legacy_world  # noqa: F401


def _epoch_records(out):
    """(epoch, steps, sites) of each epoch record legacy-train printed."""
    recs = [eval(line) for line in out.splitlines()
            if line.startswith("{'epoch'")]
    return [(r["epoch"], r["steps"], r["sites"]) for r in recs]


def test_legacy_train_cli_two_epochs_count_as_the_jax_cli(legacy_world,
                                                          tmp_path, capsys):
    """Each epoch selects its own sites from one generator, in both
    packages: the same sites and steps in each epoch, and an archive for
    each."""
    args = _world_args(legacy_world) + ["--min-depth", "2", "--epochs", "2",
                                        "--batch-size", "16", "--seed", "3"]
    assert jax_cli(["legacy-train", *args, "-o", str(tmp_path / "j")]) == 0
    jax_out = capsys.readouterr().out
    assert torch_cli(["legacy-train", *args, "-o", str(tmp_path / "t"),
                      "--device", "cpu"]) == 0
    torch_out = capsys.readouterr().out
    want = _epoch_records(jax_out)
    assert [r[0] for r in want] == [1, 2] and all(r[1] > 0 for r in want)
    assert _epoch_records(torch_out) == want
    for name in ("catmodel_epoch1.npz", "catmodel_epoch2.npz",
                 "catmodel.npz"):
        assert (tmp_path / "t" / name).exists(), name
