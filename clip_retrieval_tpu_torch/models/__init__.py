"""CLIP towers in PyTorch, configs, tokenizer, host preprocessing, loaders."""

from .clip import CLIP, encode_image, encode_text, init_clip, l2_normalize, normalize_images  # noqa: F401
from .configs import CLIPConfig, get_config, list_configs  # noqa: F401
from .tokenizer import CLIPTokenizer  # noqa: F401
