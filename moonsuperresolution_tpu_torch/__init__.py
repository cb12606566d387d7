"""PyTorch and CUDA port of moonsuperresolution_tpu, for NVIDIA Hopper.

Lunar DEM super-resolution: a SPADE GAN turns an ortho image and a
low-resolution DEM into a high-resolution DEM, tile by tile over a whole
map, with Gaussian-blended Monte-Carlo mean, spread and coverage planes.

The package imports torch and never JAX, nor any module of
moonsuperresolution_tpu; it keeps that package's layout and names where they
help to find a module's counterpart.  Entry points run on the first CUDA card
unless given ``device="cpu"`` (see ``device.py``).  The hand-written kernels
live in ``csrc/`` and are built at first use (``build.py``).
"""
