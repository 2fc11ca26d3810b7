"""realhf_tpu_torch: the PyTorch/CUDA port of realhf_tpu.

Plain tensor code is PyTorch; the attention kernels are hand-written
CUDA C++ for Hopper (``csrc/``), built on first use. Entry points run on
the CUDA card unless the caller passes ``device="cpu"``.
"""
