"""The port's haplotype featurizer against the JAX featurizer and the
NumPy oracle, on int8/int16 read matrices with depth-pad rows."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nanosnp_tpu.features.haplotype import \
    haplotype_features as jax_haplotype_features
from nanosnp_tpu.features.haplotype import ref_position_codes as jax_pos
from nanosnp_tpu.features.haplotype import ref_window_codes as jax_win
from nanosnp_tpu_torch import constants as C
from nanosnp_tpu_torch.features.haplotype import (haplotype_features,
                                                  haplotype_features_numpy,
                                                  ref_position_codes,
                                                  ref_window_codes)


def _reads(rng, n, depth, seq_len):
    seq = rng.integers(-1, 5, (n, depth, seq_len))
    for i in range(n):                    # ragged depth: pad tail rows
        seq[i, int(rng.integers(depth // 3, depth + 1)):] = C.PAD_VALUE
    seq[0] = C.PAD_VALUE                  # a site with no reads at all
    pad = seq == C.PAD_VALUE
    # whole-read HP tags; read 1 of each site untagged (0)
    tag = rng.integers(1, 4, (n, depth, 1)).repeat(seq_len, axis=2)
    tag[:, 1] = 0
    hap = np.where(pad, C.PAD_VALUE, tag)
    bq = np.where(pad, C.PAD_VALUE, rng.integers(0, 94, seq.shape))
    mq = np.where(pad, C.PAD_VALUE, rng.integers(0, 255, seq.shape))
    ref = rng.integers(0, 5, (n, seq_len))
    return (seq.astype(np.int8), bq.astype(np.int8), mq.astype(np.int16),
            hap.astype(np.int8), ref.astype(np.int8))


@pytest.mark.parametrize("depth,seq_len", [(24, 33), (40, 11)])
def test_features_match_jax_and_oracle(depth, seq_len):
    args = _reads(np.random.default_rng(depth), 12, depth, seq_len)
    got = haplotype_features(*map(torch.from_numpy, args)).numpy()
    assert got.shape == (12, seq_len, 105) and got.dtype == np.float32
    want = np.asarray(jax_haplotype_features(*map(jnp.asarray, args)))
    # same f32 operations in the same order: equal values
    np.testing.assert_array_equal(got, want)
    oracle = haplotype_features_numpy(*[a.astype(np.int64) for a in args])
    # the oracle sums in f64: f32 rounding of the frequencies and means
    np.testing.assert_allclose(got, oracle, rtol=1e-6, atol=1e-6)
    assert np.all(got[0, :, :104] == 0)   # empty site -> zero statistics


def test_ref_codes_match_jax():
    rng = np.random.default_rng(9)
    seq = np.frombuffer("".join(rng.choice(list("ACGTNacgtn"), 300)).encode(),
                        dtype=np.uint8)
    centers = np.array([1, 5, 150, 299, 300])
    np.testing.assert_array_equal(ref_window_codes(seq, centers, 16),
                                  jax_win(seq, centers, 16))
    pos = rng.integers(-3, 310, (7, 11))
    np.testing.assert_array_equal(ref_position_codes(seq, pos),
                                  jax_pos(seq, pos))
