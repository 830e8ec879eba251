"""The SASS comparison tool (ops/sass_compare.py) on the CPU: it reads the
`ptxas -v` report and `cuobjdump -sass` text as the CUDA toolkit prints
them, and pairs the kernels of two trees by name, by identical SASS, or by
base name. Compiling and disassembling need the toolkit and run on the
card's machine."""
import pytest

from nanosnp_tpu_torch.ops import sass_compare as S

PTXAS = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN48_GLOBAL__N__1ae6fe80_15_x_cu_e51600331kILi0EEEvPKf' for 'sm_90a'
ptxas info    : Function properties for _ZN48_GLOBAL__N__1ae6fe80_15_x_cu_e51600331kILi0EEEvPKf
    152 bytes stack frame, 228 bytes spill stores, 200 bytes spill loads
ptxas info    : Used 128 registers, used 16 barriers, 152 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN48_GLOBAL__N__1ae6fe80_15_x_cu_e51600331gEv' for 'sm_90a'
ptxas info    : Function properties for _ZN48_GLOBAL__N__1ae6fe80_15_x_cu_e51600331gEv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers
"""

SASS = """\
\tcode for sm_90a
\t\tFunction : _Z1kv
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;            /* 0x00000a00ff017b82 */
                                                                     /* 0x000e620000000800 */
        /*0010*/                   EXIT ;                            /* 0x000000000000794d */
                                                                     /* 0x000fea0003800000 */
\t\t..........


\t\tFunction : _Z1gv
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_SM90"
        /*0000*/                   EXIT ;                            /* 0x000000000000794d */
                                                                     /* 0x000fea0003800000 */
"""


def test_parse_ptxas_reads_registers_and_spills_by_kernel():
    got = S.parse_ptxas(PTXAS)
    k = "_ZN48_GLOBAL__N__1ae6fe80_15_x_cu_e51600331kILi0EEEvPKf"
    g = "_ZN48_GLOBAL__N__1ae6fe80_15_x_cu_e51600331gEv"
    assert got == {k: {"registers": 128, "spill_stores": 228,
                       "spill_loads": 200},
                   g: {"registers": 32, "spill_stores": 0, "spill_loads": 0}}


def test_parse_sass_splits_functions_and_drops_encodings():
    got = S.parse_sass(SASS)
    assert set(got) == {"_Z1kv", "_Z1gv"}
    assert got["_Z1kv"][1:3] == ["/*0000*/ LDC R1, c[0x0][0x28] ;",
                                 "/*0010*/ EXIT ;"]
    assert got["_Z1gv"][1:] == ["/*0000*/ EXIT ;"]
    assert not any("0x000" in line for body in got.values()
                   for line in body)


NAMES = {
    "p_fwd": "void <unnamed>::fwd<(int)64>(const float *)",
    "c_fwd": "void <unnamed>::fwd<(int)64, (bool)1, float>(const T3 *)",
    "c_inf": "void <unnamed>::fwd<(int)64, (bool)0, float>(const T3 *)",
    "p_a": "<unnamed>::a(int)", "c_a": "<unnamed>::a(int)",
    "p_b": "<unnamed>::b(int)", "c_new": "<unnamed>::c(int)",
}


@pytest.mark.parametrize("case", ["name", "sass", "base"])
def test_pair_matches_by_name_then_sass_then_base(case):
    """Mangled names differ between trees (nvcc mangles the anonymous
    namespace by its file): a kernel pairs by its demangled name, a
    renamed one by identical SASS, else by its one unpaired namesake."""
    parent = {"p_fwd": ["X"], "p_a": ["A"], "p_b": ["B"]}
    change = {"c_a": ["A2"], "c_new": ["N"]}
    if case == "name":
        assert S.pair(parent, change, NAMES) == {"c_a": "p_a", "c_new": None}
    elif case == "sass":
        change["c_fwd"] = ["Y"]
        change["c_inf"] = ["X"]     # the parent's fwd, renamed
        got = S.pair(parent, change, NAMES)
        assert got["c_inf"] == "p_fwd" and got["c_fwd"] is None
    else:
        change["c_fwd"] = ["Y"]
        got = S.pair(parent, change, NAMES)
        assert got["c_fwd"] == "p_fwd" and got["c_a"] == "p_a"
        assert S._base(NAMES["c_fwd"]) == "fwd" == S._base(NAMES["p_fwd"])
