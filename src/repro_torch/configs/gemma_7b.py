"""Config for --arch gemma-7b (see registry.py for the exact published numbers)."""
from repro_torch.configs.registry import get

ENTRY = get("gemma-7b")
FULL = ENTRY.full
SMOKE = ENTRY.smoke
SHAPES = ENTRY.shapes
