"""The SASS counter's parser (pipeinfer_tpu_torch/tools/sass_count.py) on
a hand-written cuobjdump listing: functions are split by their headers,
the largest loop is the span from a backward branch's target to the
branch, and opcodes count by their mnemonic before the first dot,
predicates dropped; the weights a loop pass takes, by kernel and bit
width; and --kernel's choice of source. (The tool itself needs the CUDA
toolkit.)"""

from pipeinfer_tpu_torch.ops import cuda_build
from pipeinfer_tpu_torch.tools import sass_count

LISTING = """
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_19i8_kernelILi1EEEvNS_4ArgsE
\t.headerflags\t@"EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                /* 0x00000a00ff017b82 */
                                                                         /* 0x000fe20000000800 */
        /*0010*/                   S2R R0, SR_TID.X ;                    /* 0x0000000000007919 */
.L_x_1:
        /*0020*/                   PRMT R4, R2, 0x5440, R3 ;             /* 0x0000544002047816 */
        /*0030*/                   FADD R4, R4, -8388736 ;               /* 0x4b00008004047421 */
        /*0040*/                   FMUL R5, R4, R6 ;                     /* 0x0000000604057220 */
        /*0050*/                   F2FP.BF16.F32.PACK_AB R5, R5, R7 ;    /* 0x000000070505723e */
.L_x_0:
        /*0060*/                   FFMA R8, R5, R9, R8 ;                 /* 0x0000000905087223 */
        /*0070*/              @!P0 BRA `(.L_x_0) ;                       /* 0x0000000000008947 */
        /*0080*/                   IMAD.SHL.U32 R5, R5, 0x10000, RZ ;    /* 0x0001000005057824 */
        /*0090*/               @P1 BRA `(.L_x_1) ;                       /* 0x0000000000008947 */
        /*00a0*/                   BRA `(.L_x_2);                        /* 0xfffffffc00fc7947 */
.L_x_2:
        /*00b0*/                   EXIT ;                                /* 0x000000000000794d */
\t\tFunction : _ZN12_GLOBAL__N_19other_kernelEv
        /*0000*/                   EXIT ;                                /* 0x000000000000794d */
"""


def test_functions_split_by_header():
    fns = sass_count.functions(LISTING)
    assert list(fns) == ["_ZN12_GLOBAL__N_19i8_kernelILi1EEEvNS_4ArgsE",
                         "_ZN12_GLOBAL__N_19other_kernelEv"]


def test_largest_loop_counts_by_mnemonic():
    ops, n = sass_count.loop_counts(sass_count.functions(LISTING)[
        "_ZN12_GLOBAL__N_19i8_kernelILi1EEEvNS_4ArgsE"])
    # the outer loop 0x20..0x90 (8 instructions), not the inner 0x60..0x70,
    # nor the forward branch to .L_x_2
    assert n == 8
    assert ops == {"PRMT": 1, "FADD": 1, "FMUL": 1, "F2FP": 1, "FFMA": 1, "BRA": 2, "IMAD": 1}


def test_a_function_without_a_loop_counts_nothing():
    fns = sass_count.functions(LISTING)
    ops, n = sass_count.loop_counts(fns["_ZN12_GLOBAL__N_19other_kernelEv"])
    assert n == 0 and not ops


def test_weights_per_pass_by_kernel():
    """i8 and i8g: 16 rows x 4 columns; i4g and k4: two nibbles a byte;
    k_major: times the planes of the instance's bit width (its first
    template argument)."""
    for kernel, weights in (("qmatmul_i8", 64), ("qmatmul_i8g", 64), ("qmatmul_i4g", 128),
                            ("qmatmul_k4", 128)):
        fn = kernel.removeprefix("qmatmul_") + "_kernel"
        name = f"_ZN12_GLOBAL__N_1{len(fn)}{fn}ILi8EEEvNS_4ArgsE"
        assert sass_count.weights_per_pass(kernel, name) == weights
    for bits, planes in {8: 1, 6: 2, 5: 2, 4: 2, 3: 4, 2: 4}.items():
        name = f"_ZN12_GLOBAL__N_113kmajor_kernelILi{bits}ELi8EEEvNS_4ArgsE"
        assert sass_count.weights_per_pass("qmatmul_kmajor", name) == 64 * planes


def test_ch_is_the_kernels_rows_per_warp():
    """The tool's CH is the constant of each kernel it counts."""
    for kernel in sass_count.KERNELS:
        text = (cuda_build.CSRC / f"{kernel}.cu").read_text()
        assert f"constexpr int CH = {sass_count.CH};" in text, kernel


def test_kernel_option_builds_that_source(monkeypatch):
    """--kernel picks the source nvcc builds (the build fails here, so the
    tool stops with 1 before disassembling)."""
    calls = []

    class Failed:
        returncode, stdout, stderr = 1, "", "no toolkit"

    monkeypatch.setattr(cuda_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(sass_count.subprocess, "run", lambda cmd, **kw: calls.append(cmd) or Failed)
    assert sass_count.main(["--kernel", "qmatmul_kmajor"]) == 1
    assert calls[0][-1] == str(cuda_build.CSRC / "qmatmul_kmajor.cu")
    assert sass_count.main([]) == 1
    assert calls[1][-1] == str(cuda_build.CSRC / "qmatmul_i8.cu")
