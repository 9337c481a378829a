"""Run the checked-in experiment recipes on the port.

Counterpart of the reference's ``tools/run_recipe.py``: it reads the same
``recipes/*.toml`` (each ``[[run]]`` one CLI invocation with its exact
hyperparameters) and launches each run as ``python -m
ant_quantization_tpu_torch.tools.<tool>`` with the reference's flags.
A run whose tool the port lacks raises and names the ROADMAP item that
ports it.

Usage:
  python -m ant_quantization_tpu_torch.tools.run_recipe \\
      recipes/olive_glue.toml --list
  python -m ant_quantization_tpu_torch.tools.run_recipe \\
      recipes/olive_glue.toml --only bert_base_sst2 -- \\
      --data_dir /data/glue/SST-2 --weights /data/bert-base-sst2

Everything after ``--`` is appended verbatim to each launched command
(data paths, ``--device cpu``, ``--output``, ...). ``--set
'GLOB:key=value'`` (repeatable) sets a flag only for the runs whose name
matches the glob, for example the dev json of SQuAD v1.1 and v2.0 runs:

  python -m ant_quantization_tpu_torch.tools.run_recipe \\
      recipes/olive_squad.toml \\
      --set '*_squad:data=/data/dev-v1.1.json' \\
      --set '*_squad2:data=/data/dev-v2.0.json'
"""

from __future__ import annotations

import argparse
import fnmatch
import subprocess
import sys
import tomllib

__all__ = ["PORTED_TOOLS", "MISSING_TOOLS", "load_recipe", "parse_sets",
           "build_command", "main"]

PACKAGE = "ant_quantization_tpu_torch"
RESERVED = {"name", "tool", "notes"}
PORTED_TOOLS = ("glue_run", "squad_run", "clm_eval", "serve_cli",
                "imagenet_eval", "imagenet_qat", "qat_bench", "lm_bench",
                "spec_bench", "tp_bench")
# the reference's tools that the port lacks, by the ROADMAP item that
# ports them (none is left)
MISSING_TOOLS: dict = {}


def load_recipe(path: str) -> dict:
    with open(path, "rb") as f:
        doc = tomllib.load(f)
    if "run" not in doc:
        raise SystemExit(f"{path}: no [[run]] entries")
    return doc


def parse_sets(pairs: list) -> list:
    """Parse --set 'GLOB:key=value' strings into (glob, key, value)."""
    out = []
    for s in pairs:
        head, sep, value = s.partition("=")
        if not sep or ":" not in head:
            raise SystemExit(f"--set {s!r}: expected GLOB:key=value")
        glob, _, key = head.rpartition(":")
        out.append((glob, key, value))
    return out


def build_command(run: dict, defaults: dict, extra: list, sets=()) -> list:
    """The run's command line: ``python -m`` the port's tool, then the
    merged flags in the reference's order and form, then ``extra``."""
    merged = {**defaults, **run}
    for glob, key, value in sets:
        if fnmatch.fnmatch(run.get("name", ""), glob):
            merged[key] = value
    tool = merged.get("tool")
    name = run.get("name")
    if not tool:
        raise SystemExit(f"run {name}: no tool")
    if tool not in PORTED_TOOLS:
        item = MISSING_TOOLS.get(tool, "no ROADMAP item")
        raise NotImplementedError(
            f"run {name}: the tool {tool!r} is not ported to PyTorch yet "
            f"({item})")
    cmd = [sys.executable, "-m", f"{PACKAGE}.tools.{tool}"]
    for key, val in merged.items():
        if key in RESERVED:
            continue
        flag = "--" + key
        if isinstance(val, bool):
            if val:
                cmd.append(flag)
        else:
            cmd += [flag, str(val)]
    return cmd + list(extra)


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    extra = []
    if "--" in argv:
        cut = argv.index("--")
        argv, extra = argv[:cut], argv[cut + 1:]
    p = argparse.ArgumentParser()
    p.add_argument("recipe")
    p.add_argument("--only", default="*",
                   help="glob over run names (default: all)")
    p.add_argument("--list", action="store_true")
    p.add_argument("--dry-run", action="store_true",
                   help="print commands without executing")
    p.add_argument("--keep-going", action="store_true",
                   help="continue past failing runs")
    p.add_argument("--set", action="append", default=[], dest="sets",
                   metavar="GLOB:key=value",
                   help="override/add a flag only for runs whose name "
                        "matches GLOB (repeatable)")
    args = p.parse_args(argv)
    sets = parse_sets(args.sets)

    doc = load_recipe(args.recipe)
    defaults = doc.get("defaults", {})
    if args.list:
        for r in doc["run"]:
            print(r.get("name", "?"))
        return 0
    runs = [r for r in doc["run"]
            if fnmatch.fnmatch(r.get("name", ""), args.only)]
    if not runs:
        raise SystemExit(f"no runs match --only {args.only!r}")

    failed = []
    for r in runs:
        cmd = build_command(r, defaults, extra, sets)
        print(f"[{r['name']}] " + " ".join(cmd), flush=True)
        if args.dry_run:
            continue
        rc = subprocess.call(cmd)
        if rc != 0:
            failed.append(r["name"])
            if not args.keep_going:
                raise SystemExit(rc)
    if failed:
        print("FAILED: " + ", ".join(failed), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
