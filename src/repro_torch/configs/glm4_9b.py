"""Config for --arch glm4-9b (see registry.py for the exact published numbers)."""
from repro_torch.configs.registry import get

ENTRY = get("glm4-9b")
FULL = ENTRY.full
SMOKE = ENTRY.smoke
SHAPES = ENTRY.shapes
