"""voidin-tpu on PyTorch + CUDA: the renderer's north-star frame for one
NVIDIA H100 (Hopper).

A second package beside ``voidin_tpu`` (the JAX/Pallas reference), with its
layout and function names. It imports torch and numpy, never jax or flax.
The frame's two TPU kernels are hand-written CUDA C++ for sm_90a
(``csrc/``), built with nvcc at first use; each has a plain PyTorch twin
that the CPU path runs.
"""

from .core.camera import Camera, CameraUniform, build_uniform
from .scene.scene import SceneData, World, scene_from_numpy

__version__ = "0.1.0"
