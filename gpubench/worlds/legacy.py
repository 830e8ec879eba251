"""A seeded legacy world for the CatModel trainer, numpy only, and the
CatModel's seeded weights.

The world is what legacy-train reads from a user's dual-tag bins after
aligning them: for each group (a candidate site and its 11 positions),
per HP tag the surrounding and the adjacent-het read matrices with their
base and mapping qualities, a ragged depth a tag (pad rows -2, so the
images carry real padding), and the truth label at the group's center.
After chip_smoke.py's legacy world (`_legacy_tag_arrays`), never
imported from there: tag 1 carries the alt base at every variant, tag 2
only at homozygous ones; reads agree with their tag's base with
probability 0.85 (the het view) and with a per-column consensus with
0.9 (the surrounding view).
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

POSITIONS = 11
GT10 = ["AA", "AC", "AG", "AT", "CC", "CG", "CT", "GG", "GT", "TT"]


class LegacyWorld(NamedTuple):
    # per view ("surrounding", "het"), per tag: {read, baseq, mapq}
    # [n, max_depth, 11] int8, pad -2 past the tag's depth
    views: Dict[str, Tuple[dict, dict]]
    labels: np.ndarray      # [n, 3] int64: confident, gt class, zygosity


def legacy_world(rng: np.random.Generator, groups: int,
                 depth: Tuple[int, int], max_depth: int,
                 variant_frac: float, het_frac: float) -> LegacyWorld:
    """`groups` groups; each tag's depth uniform in [depth[0], depth[1]];
    a `variant_frac` of the sites variant, `het_frac` of those
    heterozygous. Labels as legacy-train joins them: a confident site's
    gt class (of the ten SNV pairs) and zygosity (-1 at a site with no
    variant, 1 homozygous, 2 heterozygous)."""
    n = groups
    ref = rng.integers(1, 5, n)
    alt = (ref - 1 + rng.integers(1, 4, n)) % 4 + 1
    variant = rng.random(n) < variant_frac
    het = variant & (rng.random(n) < het_frac)
    tag_bases = (np.where(variant, alt, ref),
                 np.where(variant & ~het, alt, ref))
    views: Dict[str, List[dict]] = {"surrounding": [], "het": []}
    rows = np.arange(max_depth)[None, :, None]
    for bases in tag_bases:
        live = rows < rng.integers(depth[0], depth[1] + 1, n)[:, None, None]
        shape = (n, max_depth, POSITIONS)

        def reads(consensus, agree):
            r = np.where(rng.random(shape) < agree, consensus,
                         rng.integers(-1, 5, shape))
            return np.where(live, r, -2).astype(np.int8)

        for view, r in (("het", reads(bases[:, None, None], 0.85)),
                        ("surrounding", reads(
                            rng.integers(1, 5, (n, 1, POSITIONS)), 0.9))):
            views[view].append({
                "read": r,
                "baseq": np.where(live, rng.integers(0, 41, shape),
                                  -2).astype(np.int8),
                "mapq": np.where(live, rng.integers(0, 61, shape),
                                 -2).astype(np.int8)})
    first = np.minimum(*tag_bases) - 1
    second = np.maximum(*tag_bases) - 1
    letters = "ACGT"
    gt = np.array([GT10.index(letters[a] + letters[b])
                   for a, b in zip(first, second)], np.int64)
    zy = np.where(~variant, -1, np.where(het, 2, 1))
    labels = np.stack([np.ones(n, np.int64), gt, zy], axis=1)
    return LegacyWorld({k: tuple(v) for k, v in views.items()}, labels)


def catmodel_layout(model: dict) -> dict:
    """The CatModel's tree of (shape, scale, fill): uniform in (-k, k)
    with torch's default scales (k = 1/sqrt(fan in) for a convolution or a
    dense layer, 1/sqrt(H) for a BiLSTM's weights and 2/sqrt(H) for its
    folded bias); BatchNorm scale 1, bias 0, running mean 0 and variance
    1 (fill)."""
    h = model["hidden_size"]

    def bilstm(d_in, layers):
        k = h ** -0.5
        return [{"w_ih": ((2, d_in if i == 0 else 2 * h, 4 * h), k, None),
                 "w_hh": ((2, h, 4 * h), k, None),
                 "b": ((2, 4 * h), 2 * k, None)} for i in range(layers)]

    def dense(d_in, d_out):
        k = d_in ** -0.5
        return {"w": ((d_in, d_out), k, None), "b": ((d_out,), k, None)}

    def bn(c):
        return {"scale": ((c,), 0, 1.0), "bias": ((c,), 0, 0.0),
                "mean": ((c,), 0, 0.0), "var": ((c,), 0, 1.0)}

    blocks = []
    for c_in, c_out in model["res_blocks"]:
        blocks.append({
            "conv1": ((c_out, c_in, 3, 3), (9 * c_in) ** -0.5, None),
            "bn1": bn(c_out),
            "conv2": ((c_out, c_out, 3, 3), (9 * c_out) ** -0.5, None),
            "bn2": bn(c_out),
            "shortcut": ((c_out, c_in, 1, 1), c_in ** -0.5, None)})
    return {"percentage_rnn": bilstm(model["percentage_dim"],
                                     model["percentage_layers"]),
            "percentage_proj": dense(2 * h, model["proj_size"]),
            "res_blocks": blocks,
            "crnn_lstm1": bilstm(model["res_blocks"][-1][1], 1),
            "crnn_proj1": dense(2 * h, model["proj_size"]),
            "crnn_lstm2": bilstm(model["proj_size"], 1),
            "crnn_proj2": dense(2 * h, model["proj_size"]),
            "out": dense(2 * model["proj_size"], model["gt_num_class"])}


def _walk(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (i,))
    else:
        yield path, tree


def catmodel_params(model: dict, seed: int, device) -> dict:
    """The seeded CatModel tree on `device`, f32: every drawn leaf a view
    of one uniform draw of one generator, the same for a seed."""
    lay = catmodel_layout(model)
    items = list(_walk(lay))
    sizes = [int(torch.Size(shape).numel()) for _, (shape, _, _) in items]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.rand(sum(sizes), generator=gen, device=device) * 2 - 1
    tree = _copy(lay)
    for (path, (shape, k, fill)), part in zip(items, flat.split(sizes)):
        leaf = part.view(shape) * k if fill is None else \
            torch.full(shape, fill, device=device)
        node = tree
        for key in path[:-1]:
            node = node[key]
        node[path[-1]] = leaf
    return tree


def _copy(tree):
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_copy(v) for v in tree]
    return tree
