"""port_support.py, the helpers the card tooling and the tests share, on the
CPU: its reading of nvcc's ptxas report. This file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_support.py
"""

from port_support import ptxas_variants

# an excerpt of nvcc -Xptxas -v: two variants of K3's kernel (the second
# spilling), and a kernel compiled before them with no register line
PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z10early_stubv' for 'sm_90a'
ptxas info    : Compiling entry function '_Z15in_stats_kernelI13__nv_bfloat16Lb1EEvPKT_Pfiii' for 'sm_90a'
ptxas info    : Function properties for _Z15in_stats_kernelI13__nv_bfloat16Lb1EEvPKT_Pfiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, used 1 barriers, 2048 bytes smem, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_Z15in_stats_kernelIfLb0EEvPKT_Pfiii' for 'sm_90a'
ptxas info    : Function properties for _Z15in_stats_kernelIfLb0EEvPKT_Pfiii
    16 bytes stack frame, 12 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 255 registers, 400 bytes cmem[0]
"""


def test_ptxas_variants_reads_each_compiled_kernel():
    assert ptxas_variants(PTXAS_LOG) == [
        {"name": "_Z10early_stubv", "registers": None, "smem_bytes": 0, "spill_bytes": 0},
        {"name": "_Z15in_stats_kernelI13__nv_bfloat16Lb1EEvPKT_Pfiii", "registers": 32,
         "smem_bytes": 2048, "spill_bytes": 0},
        {"name": "_Z15in_stats_kernelIfLb0EEvPKT_Pfiii", "registers": 255, "smem_bytes": 0,
         "spill_bytes": 20}]
    assert ptxas_variants(None) == ptxas_variants("") == []
