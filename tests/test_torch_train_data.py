"""The port's copies of the training data path (train/data.py, labels.py,
metrics.py, losses.py, utils/profiling.count_parameters) against the JAX
package's originals, on the same numpy-seeded inputs: the batches the
trainers see must be the same arrays in the same order."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from nanosnp_tpu.config import PileupModelConfig as JPileCfg
from nanosnp_tpu.models.pileup_model import \
    init_pileup_params as jax_init_pileup
from nanosnp_tpu.train import data as JD
from nanosnp_tpu.train import labels as JL
from nanosnp_tpu.train import losses as jax_losses
from nanosnp_tpu.train import metrics as JM
from nanosnp_tpu.utils.profiling import \
    count_parameters as jax_count_parameters
from nanosnp_tpu_torch.io import bins
from nanosnp_tpu_torch.io.fasta import write_fasta
from nanosnp_tpu_torch.models.convert import params_from_jax
from nanosnp_tpu_torch.train import data as D
from nanosnp_tpu_torch.train import labels as L
from nanosnp_tpu_torch.train import losses
from nanosnp_tpu_torch.train import metrics as M
from nanosnp_tpu_torch.utils.profiling import count_parameters

# f32 log-softmax and means on both sides: summation order only
LOSS_RTOL = 1e-6


@pytest.mark.parametrize("name", ["label_smoothing_loss", "focal_loss"])
def test_losses_match_jax(name):
    rng = np.random.default_rng(1)
    logits = (rng.standard_normal((37, 21)) * 3).astype(np.float32)
    targets = rng.integers(0, 21, 37)
    want = float(getattr(jax_losses, name)(jnp.asarray(logits),
                                           jnp.asarray(targets)))
    got = float(getattr(losses, name)(torch.from_numpy(logits),
                                      torch.from_numpy(targets)))
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


def _arrays(mod, rng, n):
    label = np.zeros((n, 90), np.int32)
    label[np.arange(n), rng.integers(0, 21, n)] = 1
    label[np.arange(n), 21 + rng.integers(0, 3, n)] = 1
    return mod.PileupTrainArrays(
        rng.integers(-9, 9, (n, 33, 18)).astype(np.int32), label,
        np.arange(n, dtype=np.int64), np.zeros(n, bool))


@pytest.mark.parametrize("use_balance", [False, True])
def test_pileup_batches_match_jax(use_balance):
    got = list(D.batch_iterator(_arrays(D, np.random.default_rng(2), 150),
                                32, np.random.default_rng(3), epochs=2,
                                use_balance=use_balance, mark_epochs=True))
    want = list(JD.batch_iterator(_arrays(JD, np.random.default_rng(2), 150),
                                  32, np.random.default_rng(3), epochs=2,
                                  use_balance=use_balance, mark_epochs=True))
    assert len(got) == len(want) > 2
    for g, w in zip(got, want):
        if w is JD.EPOCH_END:
            assert g is D.EPOCH_END
            continue
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


def test_haplotype_batches_and_reshard_match_jax(tmp_path):
    """Shards written by the port, split and batched by both packages'
    code with the same seeds: the same files, rows and batches."""
    rng = np.random.default_rng(4)
    length, n = 3000, 150
    seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, length)]
    write_fasta(str(tmp_path / "ref.fa"), {"chr1": seq.tobytes().decode()})
    pos = np.sort(rng.choice(np.arange(50, length - 50), n,
                             replace=False)).astype(np.int64)
    paths = []
    for depth, sl in ((7, slice(0, n, 2)), (20, slice(1, n, 2))):
        c = pos[sl]
        views = []
        for seq_len in (33, 11):
            s = rng.integers(-2, 5, (len(c), depth, seq_len)).astype(np.int8)
            views.append({"sequences": s,
                          "hap": np.where(s == -2, -2, rng.integers(
                              1, 4, s.shape)).astype(np.int8),
                          "baseq": rng.integers(0, 60, s.shape).astype(
                              np.int8),
                          "mapq": rng.integers(0, 61, s.shape).astype(
                              np.int16)})
        paths.append(str(tmp_path / f"chr1_d{depth}.npz"))
        bins.save_haplotype_shard(paths[-1], bins.HaplotypeShard(
            contig="chr1", candidate_positions=c,
            group_positions=c[:, None] + np.arange(-5, 6)[None, :],
            pileup=views[0], haplotype=views[1]))
    vcf = [f"chr1\t{p}\t.\t{chr(seq[p - 1])}\t"
           f"{'ACGT'[('ACGT'.index(chr(seq[p - 1])) + 1) % 4]}\t50\tPASS\t."
           f"\tGT\t{'0|1' if p % 2 else '1|1'}" for p in pos[::3]]
    bed = [("chr1", 0, length)]
    seqs = {"chr1": seq}
    truth = L.truth_arrays({"chr1": length}, seqs, bed, vcf)
    jtruth = JL.truth_arrays({"chr1": length}, seqs, bed, vcf)
    np.testing.assert_array_equal(truth["chr1"], jtruth["chr1"])

    split = D.reshard_train_val(paths, str(tmp_path / "port"), 0.2,
                                np.random.default_rng(5))
    jsplit = JD.reshard_train_val(paths, str(tmp_path / "jax"), 0.2,
                                  np.random.default_rng(5))
    for ours, theirs in zip(split, jsplit):
        assert [p.replace("/port/", "/") for p in ours] == \
            [p.replace("/jax/", "/") for p in theirs]
    D.set_reference_for_training(seqs)
    JD.set_reference_for_training(seqs)
    got = list(D.haplotype_train_iterator(split[0], truth, 16,
                                          np.random.default_rng(6), epochs=2,
                                          mark_epochs=True))
    want = list(JD.haplotype_train_iterator(jsplit[0], jtruth, 16,
                                            np.random.default_rng(6),
                                            epochs=2, mark_epochs=True))
    assert len(got) == len(want) > 4
    for g, w in zip(got, want):
        if w is JD.EPOCH_END:
            assert g is D.EPOCH_END
            continue
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_metrics_match_jax():
    rng = np.random.default_rng(7)
    pred, true = rng.integers(0, 5, 200), rng.integers(0, 5, 200)
    ours, theirs = M.ConfusionAccumulator(5), JM.ConfusionAccumulator(5)
    ours.update(pred, true)
    theirs.update(pred, true)
    assert ours.summary("gt_") == theirs.summary("gt_")


def test_count_parameters_and_lookahead_pair_carry_over():
    params = jax_init_pileup(jax.random.key(0), JPileCfg())
    assert count_parameters(params_from_jax(jax.tree.map(
        np.asarray, params))) == jax_count_parameters(params) == 213_978
    pair = jax.tree.map(np.asarray, optax.LookaheadParams(
        fast=params, slow=jax.tree.map(lambda a: a + 1, params)))
    carried = params_from_jax(pair)
    assert set(carried) == {"fast", "slow"}
    torch.testing.assert_close(carried["slow"]["proj"]["b"],
                               carried["fast"]["proj"]["b"] + 1)
