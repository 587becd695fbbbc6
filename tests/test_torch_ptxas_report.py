"""``lshm_tpu_torch.tools.ptxas_report``'s reading of a ``-Xptxas -v`` log (the tool
itself needs ``nvcc``; its parser does not)."""

from lshm_tpu_torch.tools.ptxas_report import parse, sass_digests, short_name

K8 = "_ZN2tc17head_dx_tc_kernelILi8EEEvPKfi"
K4 = "_ZN2tc17head_dx_tc_kernelILi4EEEvPKfi"
DEV = "_ZN2tc6helperEv"
LOG = f"""ptxas info    : 0 bytes gmem
ptxas info    : Function properties for {DEV}
    24 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Compiling entry function '{K8}' for 'sm_90a'
ptxas info    : Function properties for {K8}
    40 bytes stack frame, 36 bytes spill stores, 32 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 40 bytes cumulative stack size
ptxas info    : Compile time = 208.638 ms
ptxas info    : Compiling entry function '{K4}' for 'sm_90a'
ptxas info    : Function properties for {K4}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Function properties for {DEV}
    24 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 72 registers, 380 bytes cmem[0]
"""


def test_parse_reads_each_kernel_and_skips_device_functions():
    assert parse(LOG) == [
        {"mangled": K8, "stack": 40, "spill_stores": 36, "spill_loads": 32,
         "registers": 128, "barriers": 1},
        {"mangled": K4, "stack": 0, "spill_stores": 0, "spill_loads": 0,
         "registers": 72, "barriers": 0},
    ]


def test_short_name_drops_namespace_and_parameters():
    full = ("void (anonymous namespace)::tc::head_dx_tc_kernel<4>(__nv_bfloat16 const*, "
            "float const*, int, int, int, __nv_bfloat16*)")
    assert short_name(full) == "tc::head_dx_tc_kernel<4>"
    assert short_name("head_fwd_kernel<float, 4, true>(float const*)") == \
        "head_fwd_kernel<float, 4, true>"


SASS = f"""
Fatbin elf code:
================
arch = sm_90a
\t\tFunction : {K8}
\t.headerflags\t@"EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;          /* 0x00000a00ff017b82 */
        /*0010*/                   EXIT ;                          /* 0x000000000000794d */
\t\t..........

\t\tFunction : {K4}
\t.headerflags\t@"EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;          /* 0x00000a00ff017b82 */
        /*0010*/                   EXIT ;                          /* 0x000000000000794d */
\t\t..........

\t\tFunction : {DEV}
\t.headerflags\t@"EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   RET.ABS.NODEC R20 0x0 ;         /* 0x0000000014007950 */
\t\t..........
"""


def test_sass_digests_key_each_function_by_its_code():
    d = sass_digests(SASS)
    assert set(d) == {K8, K4, DEV}
    assert d[K8] == d[K4] != d[DEV]             # same instructions, same digest
    assert all(len(v) == 16 for v in d.values())
    assert sass_digests(SASS.replace("EXIT", "BRA"))[K8] != d[K8]
