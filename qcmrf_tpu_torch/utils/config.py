"""Configuration for the drivers (the part of :mod:`qcmrf_tpu.utils.config`
that ``run`` and ``eval`` use).

:data:`CONFIG_KEYS` are the keys a JAX ``--config`` file may hold (the
field names of ``qcmrf_tpu.utils.config.Config``), so one file serves both
packages. A key that names no flag of the command is ignored with a
warning; ``platform`` here is ``cpu | gpu | default``.
"""

from __future__ import annotations

import json
import sys

import torch

CONFIG_KEYS = frozenset({
    "scale", "reps", "seed", "models_path", "engine", "shots",
    "sample_seed", "data_seed", "platform", "mesh_shape", "mesh_axes",
    "outdir",
})


def parse_with_config(parser, argv=None):
    """Parse args with ``--config cfg.json`` support: the file's keys
    become the parser's defaults (explicit CLI flags still win,
    via a re-parse after installing the defaults)."""
    parser.add_argument("--config", type=str, default=None,
                        help="JSON Config file supplying defaults "
                             "(explicit flags override).")
    args = parser.parse_args(argv)
    if args.config:
        with open(args.config) as f:
            raw = json.load(f)
        # only keys PRESENT in the file become defaults, so each CLI keeps
        # its own defaults (eval's platform="cpu") for the rest
        known_dests = {a.dest for a in parser._actions}
        unknown = set(raw) - CONFIG_KEYS
        if unknown:
            raise SystemExit(
                f"--config {args.config}: unknown keys {sorted(unknown)}; "
                f"valid keys: {sorted(CONFIG_KEYS)}"
            )
        ignored = sorted(k for k in raw if k not in known_dests)
        if ignored:
            print(
                f"--config {args.config}: keys {ignored} have no "
                f"corresponding flag on this command and were ignored",
                file=sys.stderr,
            )
        parser.set_defaults(**{
            k: v for k, v in raw.items()
            if k in known_dests and v is not None
        })
        args = parser.parse_args(argv)
    return args


def dump_effective_config(args, path: str) -> None:
    """Write the parsed namespace as JSON next to the run's outputs."""
    d = {k: v for k, v in vars(args).items()
         if isinstance(v, (int, float, str, bool, type(None), list, tuple))}
    with open(path, "w") as f:
        json.dump(d, f, indent=2, default=str)


def resolve_platform(platform: str) -> torch.device:
    """The device a ``--platform`` choice names: ``cpu``, or the current
    CUDA device for ``gpu`` and ``default``. Raises when a GPU is asked
    for and PyTorch sees no CUDA device; there is no fallback."""
    if platform == "cpu":
        return torch.device("cpu")
    if platform not in ("gpu", "default"):
        raise ValueError(f"unknown platform {platform!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"--platform {platform} needs a CUDA device and PyTorch sees "
            "none; pass --platform cpu (device='cpu' from Python) to run "
            "on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` when the caller names
    one, else the current CUDA device, as for ``--platform default``
    (raising when there is none)."""
    if device is None:
        return resolve_platform("default")
    return torch.device(device)
