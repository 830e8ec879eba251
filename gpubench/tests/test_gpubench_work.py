"""work/: the bounds that the roofline metrics divide by, against the
bound column of PERF.md's kernel table (rows 2-7, the shapes of the main
paths), and the models' FLOP a site."""
import pytest

import harness

FAM = harness.work_families()
ROWS = [  # (family, call, PERF.md bound in ms, rounded to 3 places)
    ("lstm_fwd", dict(op="lstm_train", n=2000, L=33, H=64), 0.061),
    ("lstm_fwd", dict(op="lstm_train", n=512, L=33, H=256), 0.062),
    ("lstm_fwd", dict(op="lstm_train", n=512, L=11, H=256), 0.021),
    ("lstm_bwd", dict(op="lstm_train", n=2000, L=33, H=64), 0.111),
    ("lstm_bwd", dict(op="lstm_train", n=512, L=33, H=256), 0.114),
    ("lstm_bwd", dict(op="lstm_train", n=512, L=11, H=256), 0.038),
    ("lstm_dw", dict(op="lstm_train", n=512, L=33, H=256), 0.052),
    ("lstm_dw", dict(op="lstm_train", n=512, L=11, H=256), 0.016),
    ("bilstm_split", dict(op="bilstm_layer", n=8192,
                          L=33, D=105, H=256, center=False, last=False), 0.404),
    ("bilstm_split", dict(op="bilstm_layer", n=8192,
                          L=33, D=512, H=256, center=False, last=False), 0.860),
    ("bilstm_split", dict(op="bilstm_layer", n=8192,
                          L=11, D=105, H=256, center=False, last=False), 0.135),
    ("bilstm_split", dict(op="bilstm_layer", n=8192,
                          L=11, D=512, H=256, center=False, last=False), 0.287),
    ("bilstm_split", dict(op="bilstm_layer", n=8192,
                          L=33, D=512, H=256, center=True, last=True), 0.443),
    ("bilstm_split", dict(op="bilstm_layer", n=8192,
                          L=11, D=512, H=256, center=True, last=True), 0.156),
    ("bilstm_fused", dict(op="bilstm_layer", n=8192,
                          L=33, D=128, H=64, center=True, last=True), 0.028),
    ("bilstm_fused", dict(op="bilstm_layer", n=8192,
                          L=33, D=18, H=64, center=False, last=False), 0.024),
]


@pytest.mark.parametrize("family,call,want", ROWS,
                         ids=[f"{r[0]}-{i}" for i, r in enumerate(ROWS)])
def test_bound_matches_the_kernel_table(family, call, want):
    assert round(FAM[family].bound(call) * 1e3, 3) == want


def test_dw_at_h64_counts_nothing_the_sweep_has_not():
    assert FAM["lstm_dw"].bound(dict(op="lstm_train", n=2000, L=33,
                                     H=64)) == 0.0


CALLS = [dict(op="lstm_train", n=512, L=33, H=256),
         dict(op="bilstm_layer", n=8192, L=33, D=18, H=64, center=False,
              last=False),
         dict(op="bilstm_layer", n=8192, L=33, D=105, H=256, center=False,
              last=False)]


@pytest.mark.parametrize("call", CALLS, ids=["train", "fused", "split"])
def test_each_call_is_claimed_by_its_families_alone(call):
    """A driver reports shapes only; the work files decide which calls
    are theirs: each inference layer by one family, each training layer
    by the forward, the sweep and dW."""
    claim = sorted(n for n, f in FAM.items()
                   if hasattr(f, "KERNELS") and f.bound(call) is not None)
    want = {"train": ["lstm_bwd", "lstm_dw", "lstm_fwd"],
            "fused": ["bilstm_fused"], "split": ["bilstm_split"]}
    assert claim == want[{"lstm_train": "train"}.get(
        call["op"], "fused" if call["H"] <= 64 else "split")]


class _Trace:
    def __init__(self, ran):
        self.ran = ran

    def kernel_seconds(self, names):
        hit = [n for n in names if n in self.ran]
        return (1e-3 * len(hit), len(hit))


def test_roofline_counts_only_families_whose_kernels_ran():
    """A family whose kernels the trace lacks counts neither its calls nor
    its time: a kernel under a new name is one new work file."""
    from _common import roofline

    class Ctx:
        window = {"calls": [dict(CALLS[1], count=10)]}

    Ctx.trace = _Trace({"bilstm_fused_kernel"})
    want = 100 * FAM["bilstm_fused"].bound(CALLS[1]) * 10 / 1e-3
    assert roofline(Ctx) == pytest.approx(want)
    Ctx.trace = _Trace({"some_new_kernel"})
    assert roofline(Ctx) is None


def test_model_flop_a_site():
    pile = harness.load_cell("pileup.s2")["config_data"]["model"]
    hap = harness.load_cell("haplotype.s5")["config_data"]["model"]
    assert round(FAM["pileup_model"].forward_flop(pile, True) / 1e6, 2) == 9.37
    assert round(FAM["haplotype_model"].forward_flop(hap, True) / 1e6, 1) \
        == 342.7
    # inference needs the last layer's center state only
    assert FAM["haplotype_model"].forward_flop(hap, False) < \
        FAM["haplotype_model"].forward_flop(hap, True)


def test_every_family_names_its_kernels():
    for name, fam in FAM.items():
        if name.endswith("_model"):
            continue
        assert fam.KERNELS and all(k.endswith("_kernel") for k in fam.KERNELS)
