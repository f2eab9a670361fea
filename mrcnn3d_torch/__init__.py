"""PyTorch / CUDA port of the mrcnn3d 3-D Multi-Resolution R-CNN.

The package mirrors the module names of `mrcnn3d` (the JAX reference) so
each module's counterpart is easy to find.  It imports torch and numpy
only.  Tensors are NCDHW, as in the reference mmdet code; the two CUDA
kernels (`csrc/nms3d.cu`, `csrc/roi_align3d.cu`) are built with nvcc at
first use and bound with ctypes (`ops/_cuda.py`), the host runtime
(`csrc/host_ops.cpp`) with g++ (`native`).

Entry point: `mrcnn3d_torch.entry.build(...)` then `.run(imgs, imgs_2)`,
or `.tiled(dict(imgs=volume), ...)` for a whole volume.
"""
