"""Configurations by name: configs/<name>.json, its scene made by
recipes/<recipe>.py build(params, seed)."""

import importlib
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load(name):
    with open(os.path.join(HERE, "configs", f"{name}.json")) as f:
        cfg = json.load(f)
    if cfg["name"] != name:
        raise ValueError(f"configs/{name}.json names {cfg['name']!r}")
    return cfg


def build_scene(config, seed):
    recipe = importlib.import_module(f"recipes.{config['recipe']}")
    return recipe.build(config["scene"], int(seed))
