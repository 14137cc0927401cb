"""clip-retrieval-tpu-torch CLI: the port's subcommands.

Same signature-driven argparse as `clip_retrieval_tpu/cli.py`: the options
of a subcommand are the target function's parameters, so
`clip-retrieval-tpu-torch inference --input_dataset d --output_folder o
--clip_model ViT-L/14` calls `inference.main.main(...)` and
`clip-retrieval-tpu-torch back --indices_paths p.json --device cpu` calls
`back.app.clip_back(...)`.  The port has 11 of the JAX CLI's 12 subcommands:
`inference`, `index`, `filter`, `back`, `front`, `end2end`, `index_combiner`,
`parquet_to_arrow`, `inference.worker`, `convert` and `convert.nsfw_keras`
(`inference.slurm_worker` is not ported yet).  Also runnable as
`python -m clip_retrieval_tpu_torch.cli ...`.
"""

from __future__ import annotations

import argparse
import ast
import inspect
import sys
from typing import Any, Callable


def _lazy_commands() -> dict[str, Callable[[], Callable]]:
    """Subcommand → import-on-demand target (keeps CLI start fast)."""

    def inference():
        from .inference.main import main as fn

        return fn

    def index():
        from .index.build import clip_index as fn

        return fn

    def filter_():
        from .filter import clip_filter as fn

        return fn

    def back():
        from .back.app import clip_back as fn

        return fn

    def front():
        from .front import clip_front as fn

        return fn

    def end2end():
        from .end2end import clip_end2end as fn

        return fn

    def index_combiner():
        from .index.combiner import index_combiner as fn

        return fn

    def parquet_to_arrow():
        from .back.prepro import parquet_to_arrow as fn

        return fn

    def inference_worker():
        from .inference.worker import worker as fn

        return fn

    def convert():
        from .models.convert import convert as fn

        return fn

    def convert_nsfw_keras():
        from .models.convert import convert_keras_nsfw as fn

        return fn

    return {
        "convert": convert,
        "convert.nsfw_keras": convert_nsfw_keras,
        "inference": inference,
        "index": index,
        "filter": filter_,
        "back": back,
        "front": front,
        "end2end": end2end,
        "index_combiner": index_combiner,
        "parquet_to_arrow": parquet_to_arrow,
        "inference.worker": inference_worker,
    }


def _coerce(value: str) -> Any:
    """Parse CLI strings into python values: int/float/bool/list/None/str."""
    try:
        return ast.literal_eval(value)
    except (ValueError, SyntaxError):
        lowered = value.lower()
        if lowered in ("true", "false"):
            return lowered == "true"
        if lowered in ("none", "null"):
            return None
        return value


def _build_parser(fn: Callable, prog: str) -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog=prog, description=(fn.__doc__ or "").split("\n")[0])
    for name, param in inspect.signature(fn).parameters.items():
        if param.kind in (param.VAR_POSITIONAL, param.VAR_KEYWORD):
            continue
        if param.default is inspect.Parameter.empty:
            parser.add_argument(f"--{name}", required=True)
        else:
            parser.add_argument(f"--{name}", default=param.default)
    return parser


def main(argv: list[str] | None = None):
    argv = sys.argv[1:] if argv is None else argv
    commands = _lazy_commands()
    top = argparse.ArgumentParser(prog="clip-retrieval-tpu-torch")
    top.add_argument("command", choices=sorted(commands))
    if not argv or argv[0] in ("-h", "--help"):
        top.parse_args(argv or ["-h"])
        return
    command, rest = argv[0], argv[1:]
    if command not in commands:
        top.error(f"unknown command {command!r}")
    fn = commands[command]()
    ns = _build_parser(fn, prog=f"clip-retrieval-tpu-torch {command}").parse_args(rest)
    kwargs = {k: (_coerce(v) if isinstance(v, str) else v) for k, v in vars(ns).items()}
    result = fn(**kwargs)
    if result is not None:
        print(result)


if __name__ == "__main__":
    main()
