"""Yaml-config + CLI override resolution (the port's copy of
``fcl_taco2_tpu/utils/cliconf.py``; yaml is imported only when a config
file is given, and without PyYAML a JSON config file, or a flat yaml
mapping of scalars such as ``conf/*.yaml``, still parses).

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
    except ImportError:
        with open(path) as f:
            return parse_flat_config(f.read(), path)
    with open(path) as f:
        return yaml.safe_load(f) or {}


def _scalar(text):
    """A yaml 1.1 plain scalar as PyYAML's safe loader reads the ones the
    configs use: booleans, null, ints, floats with a dot, else a string."""
    low = text.lower()
    if low in ("true", "yes", "on"):
        return True
    if low in ("false", "no", "off"):
        return False
    if low in ("null", "~", ""):
        return None
    if text[:1] in "'\"" and text[-1:] == text[:1]:
        return text[1:-1]
    try:
        return int(text)
    except ValueError:
        pass
    if "." in text:  # PyYAML reads 1e-3 as a string, 1.0e-3 as a float
        try:
            return float(text)
        except ValueError:
            pass
    return text


def parse_flat_config(text, path="<config>"):
    """A config file without PyYAML: JSON (a subset of yaml), or a flat
    yaml mapping of plain scalars (``key: value`` lines and ``#``
    comments, as ``conf/*.yaml`` are).  Anything else raises."""
    import json
    try:
        return json.loads(text)
    except json.JSONDecodeError:
        pass
    out = {}
    for n, line in enumerate(text.splitlines(), 1):
        body = "" if line.lstrip().startswith("#") else line.split(" #")[0]
        if not body.strip():
            continue
        key, sep, value = body.partition(":")
        if not sep or line[:1].isspace() or not key.strip() \
                or value.strip()[:1] in ("[", "{", "|", ">", "&", "*"):
            raise ImportError(
                f"{path}:{n}: PyYAML is not installed, and this line is "
                f"not a flat 'key: scalar' entry: {line!r}")
        out[key.strip()] = _scalar(value.strip())
    return out


def strtobool(v):
    if isinstance(v, bool):
        return v
    s = str(v).lower()
    if s in ("true", "1", "yes"):
        return True
    if s in ("false", "0", "no"):
        return False
    raise argparse.ArgumentTypeError(f"boolean expected, got {v!r}")
