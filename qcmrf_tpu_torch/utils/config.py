"""Typed configuration for the command-line runners (port of
:mod:`qcmrf_tpu.utils.config`).

:class:`Config` is JAX's dataclass, field for field, so that one JSON file
serves both packages (:meth:`Config.to_json`, :meth:`Config.from_json`);
:data:`CONFIG_KEYS` are its field names, the keys a ``--config`` file may
hold. A key that names no flag of the command is ignored with a warning;
``platform`` here is ``cpu | gpu | default``. JAX's
``enable_compilation_cache`` (XLA's persistent cache for the TPU's
remote compiles) has no counterpart: the port's kernels are built once
into ``build/`` (``ops/_build.py``).
"""

from __future__ import annotations

import dataclasses
import json
import sys
from typing import Optional, Tuple

import torch


@dataclasses.dataclass
class Config:
    # suite
    scale: float = 0.5
    reps: int = 10
    seed: int = 1984          # suite-generation seed (the reference's)
    models_path: Optional[str] = None   # load instead of regenerate

    # execution
    engine: str = "analytic"  # analytic | statevector | noisy:<preset> ...
    shots: int = 10_000
    sample_seed: int = 0      # shot-sampling stream (run)
    data_seed: int = 0        # training-data generation (train)
    platform: str = "default"  # cpu | gpu | default

    # sharding
    mesh_shape: Tuple[int, ...] = ()    # () = one device
    mesh_axes: Tuple[str, ...] = ("amp",)

    # io
    outdir: str = "."

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(s: str) -> "Config":
        d = json.loads(s)
        d["mesh_shape"] = tuple(d.get("mesh_shape", ()))
        d["mesh_axes"] = tuple(d.get("mesh_axes", ("amp",)))
        fields = {f.name for f in dataclasses.fields(Config)}
        return Config(**{k: v for k, v in d.items() if k in fields})

    def apply_platform(self) -> torch.device:
        """The device ``platform`` names (:func:`resolve_platform`: raises
        for ``gpu`` and ``default`` where PyTorch sees no CUDA device).
        PyTorch has no global platform switch, so the device is returned
        for the caller to pass on."""
        return resolve_platform(self.platform)

    def make_mesh(self):
        """The mesh of ``mesh_shape`` over the first of
        ``sharded.visible_devices`` on :meth:`apply_platform`'s device,
        axes named by ``mesh_axes``; None for ``mesh_shape == ()``."""
        if not self.mesh_shape:
            return None
        from qcmrf_tpu_torch.parallel import sharded

        return sharded.device_mesh(self.mesh_shape,
                                   self.mesh_axes[:len(self.mesh_shape)],
                                   self.apply_platform())


CONFIG_KEYS = frozenset(f.name for f in dataclasses.fields(Config))


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
