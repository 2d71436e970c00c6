"""Model configurations the port runs (``--arch`` ids in :mod:`.registry`)
and the assigned input shapes (:mod:`.shapes`)."""

from repro_torch.configs.registry import ARCHS, get_config, get_smoke, list_archs  # noqa: F401
from repro_torch.configs.shapes import SHAPES, cell_is_live, input_specs  # noqa: F401
