"""The skin pose kernel: ops/skin.py pose_skins -> csrc/skin.cu
skin_pose_kernel (every skin of the scene in one launch). Work: each
posed triangle's three corners read their rest position, normal and
tangent (36 B), four f32 weights (16 B) and four joint indices at one
byte each (4 B), and write the posed position (12 B) and two octahedral
words (8 B): 228 B a triangle. The uv words, the handedness, the joint
rows and the BLAS and TLAS refit kernels are left out, so the bound stays
a lower bound whatever the layout."""

from pb import yardstick

MODULE = "voidin_tpu_torch.ops.skin"
CALLS = {(MODULE, "pose_skins"): "reduce"}
KERNELS = ("skin_pose_kernel",)
COUNTERS = ((MODULE, "LAUNCHES"),)
BYTES_PER_TRI = 3 * (36 + 16 + 4 + 12 + 8)


def reduce(args, kwargs, out):
    return args[0].n_tri


def bound_ms(calls):
    return sum(yardstick.bound_ms(BYTES_PER_TRI * n_tri, 0)
               for n_tri in calls[(MODULE, "pose_skins")])
