"""TAA sub-pixel jitter schedule.

16-sample Halton(2,3) sequence in [-1,1]^2, reshuffled every cycle with a
frame-seeded RNG such that the first sample of a new cycle differs from the
last sample of the previous one — semantics of taa.rs:229-238 and
taa.rs:284-299. (The reference uses rand::SmallRng; we use numpy's PCG64 —
the schedule is equally deterministic, just a different permutation.)
"""

from __future__ import annotations

import numpy as np

from .mathx import radical_inverse

N_SAMPLES = 16


class JitterSequence:
    def __init__(self, n: int = N_SAMPLES):
        self.n = n
        self.samples = np.array(
            [
                [
                    radical_inverse(i % n + 1, 2) * 2.0 - 1.0,
                    radical_inverse(i % n + 1, 3) * 2.0 - 1.0,
                ]
                for i in range(n)
            ],
            dtype=np.float32,
        )

    def get_jitter(self, frame_idx: int, width: int, height: int) -> np.ndarray:
        """Pixel-space jitter for this frame, divided by resolution."""
        if frame_idx % self.n == 0 and frame_idx > 0:
            rng = np.random.default_rng(frame_idx)
            prev = self.samples[-1].copy()
            while True:
                rng.shuffle(self.samples)
                if not np.array_equal(self.samples[0], prev):
                    break
        s = self.samples[frame_idx % self.n]
        return (s / np.array([width, height], dtype=np.float32)).astype(np.float32)
