"""Input state + keyboard action mapping.

Counterpart of ``voidin_tpu/framework/input.py`` (numpy on the host, a
copy of its code). Headless equivalent of the reference Input/KeyboardMap
(components/src/input.rs:12-236): key tick-state with just-pressed edges, a
mouse button/position record, and an action map binding keys to named
amounts with multipliers and clamping (input.rs:135-148). The reference's
runner binds WASD/QE + boost to camera motion (lib.rs:90-101);
`CameraController` reproduces that behavior for any frontend (scripted
tests, a terminal viewer, the web viewer)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np


class Input:
    """Tick-counted key state (was_just_pressed semantics, input.rs:27-29)."""

    def __init__(self):
        self.tick_count = 0
        self._pressed_at: Dict[str, int] = {}
        self.mouse_pos = np.zeros(2, np.float32)
        self.mouse_delta = np.zeros(2, np.float32)
        self.mouse_held: set = set()

    def tick(self):
        self.tick_count += 1
        self.mouse_delta = np.zeros(2, np.float32)

    def press(self, key: str):
        if key not in self._pressed_at:
            self._pressed_at[key] = self.tick_count

    def release(self, key: str):
        self._pressed_at.pop(key, None)

    def is_held(self, key: str) -> bool:
        return key in self._pressed_at

    def was_just_pressed(self, key: str) -> bool:
        return self._pressed_at.get(key) == self.tick_count

    def move_mouse(self, x: float, y: float):
        new = np.array([x, y], np.float32)
        self.mouse_delta = new - self.mouse_pos
        self.mouse_pos = new


@dataclass
class KeyBinding:
    key: str
    action: str
    multiplier: float = 1.0


@dataclass
class KeyboardMap:
    """Action accumulation with clamping (input.rs:135-148)."""

    bindings: List[KeyBinding] = field(default_factory=list)

    def bind(self, key: str, action: str, multiplier: float = 1.0):
        self.bindings.append(KeyBinding(key, action, multiplier))
        return self

    def map(self, input_: Input, clamp: Tuple[float, float] = (-1.0, 1.0)):
        actions: Dict[str, float] = {}
        for b in self.bindings:
            if input_.is_held(b.key):
                actions[b.action] = actions.get(b.action, 0.0) + b.multiplier
        return {
            k: float(np.clip(v, clamp[0], clamp[1])) for k, v in actions.items()
        }


def default_keymap() -> KeyboardMap:
    """WASD/QE + shift boost (lib.rs:90-101)."""
    m = KeyboardMap()
    m.bind("w", "move_fwd", 1.0)
    m.bind("s", "move_fwd", -1.0)
    m.bind("d", "move_right", 1.0)
    m.bind("a", "move_right", -1.0)
    m.bind("q", "move_up", -1.0)
    m.bind("e", "move_up", 1.0)
    m.bind("shift", "boost", 1.0)
    return m


class CameraController:
    """Drives a Camera from mapped actions (AppState::update, state.rs:38-80)."""

    def __init__(self, camera, speed: float = 4.0, boost: float = 8.0,
                 mouse_sensitivity: float = 0.15):
        self.camera = camera
        self.speed = speed
        self.boost = boost
        self.sens = mouse_sensitivity

    def update(self, actions: Dict[str, float], input_: Input, dt: float):
        cam = self.camera
        spd = self.speed * (self.boost if actions.get("boost") else 1.0)
        fwd = cam.forward()
        up = cam.up
        right = np.cross(fwd, up)
        right = right / max(np.linalg.norm(right), 1e-9)
        move = (
            fwd * actions.get("move_fwd", 0.0)
            + right * actions.get("move_right", 0.0)
            + up * actions.get("move_up", 0.0)
        )
        cam.position = cam.position + move * (spd * dt)
        if "left" in input_.mouse_held:
            cam.yaw -= float(input_.mouse_delta[0]) * self.sens
            cam.pitch = float(
                np.clip(cam.pitch - input_.mouse_delta[1] * self.sens, -89, 89)
            )
        cam.update(dt)
