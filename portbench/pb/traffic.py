"""The one traffic generator: a traffic mix is a data file
(traffic/<mix>.json) of the camera's path and the frame step, read here.

A frame's camera pose depends only on the frame's index, so the work of
frame k is the same however fast the program runs; and a measured window
ends on a whole lap of the path and of the scene's animation together
(window_ends), so it holds each pose equally often however many frames
the program fits into --seconds.

camera kinds:
  "static": the configuration's own camera, held still;
  "loop":   a closed circle of `radius` around the point `center_ahead`
            in front of the configuration's camera (on the ground plane
            through it), at `height`, pitch `pitch`, facing along the
            circle, one lap in `period_frames` frames; frame 0 sits at
            the configuration's camera.
"""

import json
import math
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load(name):
    with open(os.path.join(HERE, "traffic", f"{name}.json")) as f:
        return json.load(f)


class CameraPath:
    def __init__(self, traffic, config, animation_frames=1):
        self.spec = traffic["camera"]
        self.home = config["camera"]
        self.dt = float(traffic["dt"])
        # frames in one lap of the path (a still camera's lap is one
        # frame) and of the scene's animation (pb/animation.py period)
        self.lap = math.lcm(int(self.spec.get("period_frames", 1)),
                            int(animation_frames))

    def window_ends(self, frames, elapsed, seconds):
        """Whether a window of `frames` frames that has lasted `elapsed` s
        ends here: at the first whole lap of both the camera's path and
        the animation once `seconds` have passed."""
        return elapsed >= seconds and frames % self.lap == 0

    def pose(self, frame):
        """(position [x, y, z], yaw degrees, pitch degrees) of `frame`."""
        c = self.spec
        if c["kind"] == "static":
            h = self.home
            return list(h["position"]), float(h["yaw"]), float(h["pitch"])
        if c["kind"] == "loop":
            h = self.home
            yaw0 = math.radians(h["yaw"])
            # the circle's centre: center_ahead along the home camera's
            # horizontal forward (-sin yaw, 0, -cos yaw)
            cx = h["position"][0] - math.sin(yaw0) * c["center_ahead"]
            cz = h["position"][2] - math.cos(yaw0) * c["center_ahead"]
            theta = 2.0 * math.pi * (frame % c["period_frames"]) \
                / c["period_frames"]
            r = c["radius"]
            # angle 0 at the home camera; moving counter-clockwise seen
            # from above, facing along the tangent
            a = theta + yaw0
            pos = [cx + r * math.sin(a), float(c["height"]),
                   cz + r * math.cos(a)]
            yaw = math.degrees(a) - 90.0
            return pos, yaw, float(c["pitch"])
        raise ValueError(f"unknown camera kind {c['kind']!r}")
