"""Reader → mapper → writer embedding pipeline on one device."""

from .mapper import ClipMapper  # noqa: F401
from .reader import FilesReader, WebdatasetReader, folder_to_keys  # noqa: F401
from .runner import Runner, Sampler  # noqa: F401
from .writer import NumpyWriter  # noqa: F401
