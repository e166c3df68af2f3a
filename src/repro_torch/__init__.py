"""PyTorch/CUDA port of the ``repro`` package (RLinf / M2Flow reproduction).

The layout mirrors ``src/repro/`` file for file.  The port imports
``torch``, numpy and the standard library only; its hand-written Hopper
kernels live under :mod:`repro_torch.kernels`.  Entry points run on
``cuda`` unless the caller passes ``device="cpu"``.
"""
