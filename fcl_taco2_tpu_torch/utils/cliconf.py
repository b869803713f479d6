"""Yaml-config + CLI override resolution (the port's copy of
``fcl_taco2_tpu/utils/cliconf.py``; yaml is imported only when a config
file is given, and without PyYAML a JSON config file, which is also
valid yaml, still parses).

The reference uses configargparse with a --config/--config2/--config3
override chain (tts_train.py:24-43).  Same contract here:
later configs override earlier ones, explicit CLI flags override configs.
Yaml keys use dashes (reference conf/*.yaml style) and map to underscored
argparse dests.
"""

import argparse


def parse_with_configs(parser: argparse.ArgumentParser, argv):
    """Parse argv where --config/--config2/--config3 yaml files fill
    defaults before the final CLI parse."""
    pre = argparse.ArgumentParser(add_help=False)
    for flag in ("--config", "--config2", "--config3"):
        pre.add_argument(flag, default=None)
    cfg_args, _ = pre.parse_known_args(argv)

    merged = {}
    for path in (cfg_args.config, cfg_args.config2, cfg_args.config3):
        if path:
            data = _load_config(path)
            merged.update({k.replace("-", "_"): v for k, v in data.items()})

    known = {a.dest for a in parser._actions}
    unknown = sorted(k for k in merged if k not in known)
    if unknown:
        raise SystemExit(f"unknown config keys: {unknown}")
    parser.set_defaults(**merged)
    for flag in ("--config", "--config2", "--config3"):
        if not any(a.option_strings and flag in a.option_strings
                   for a in parser._actions):
            parser.add_argument(flag, default=None)
    return parser.parse_args(argv)


def _load_config(path):
    try:
        import yaml
    except ImportError:  # JSON is a subset of yaml
        import json
        with open(path) as f:
            try:
                return json.load(f)
            except json.JSONDecodeError as e:
                raise ImportError(
                    f"{path}: PyYAML is not installed, so a config file "
                    f"must be JSON ({e})") from e
    with open(path) as f:
        return yaml.safe_load(f) or {}


def strtobool(v):
    if isinstance(v, bool):
        return v
    s = str(v).lower()
    if s in ("true", "1", "yes"):
        return True
    if s in ("false", "0", "no"):
        return False
    raise argparse.ArgumentTypeError(f"boolean expected, got {v!r}")
