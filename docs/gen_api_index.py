"""Regenerate docs/API.md: module one-liners + public exports.

    python docs/gen_api_index.py > docs/API.md
"""
import ast
import pathlib

ROOT = pathlib.Path(__file__).resolve().parent.parent

GROUPS = [
    ("L0 infra", ["nn.py", "config.py", "fmt.py", "logger.py", "checkpoint.py",
                  "checkpoint_sharded.py", "profile.py", "utils.py",
                  "bindings.py", "coordinates.py"]),
    ("L1 ops (kernels)", "ops"),
    ("L2/L5 graphics", "graphics"),
    ("maths", "maths"),
    ("L3 encodings & blocks",
     ["models/grid_encodings/**", "models/blocks.py", "models/embedders.py",
      "models/embeddings.py", "models/modulations.py", "models/annealers.py",
      "models/autodecoder.py", "models/importance.py", "models/utils.py",
      "models/loss/*"]),
    ("L4 spaces & accelerations",
     ["models/spatial/*", "models/accelerations/*"]),
    ("L6 fields & models",
     ["models/model_base.py", "models/model_families.py", "models/fields/*",
      "models/fields_*.py", "models/attributes.py", "models/tetrahedral.py"]),
    ("parallel", "parallel"),
    ("L7 viz", ["gui.py", "gui_datalayers.py", "viewer.py", "plot/*"]),
]


def expand(spec):
    pkg = ROOT / "nr3d_lib_tpu"
    if isinstance(spec, str):           # a package dir
        return sorted(p for p in (pkg / spec).glob("*.py")
                      if p.name != "__init__.py")
    paths = []
    for s in spec:
        if "*" in s:
            glober = pkg.rglob if "**" in s else pkg.glob
            paths += sorted(p for p in glober(s.replace("**", "*/*"))
                            if p.name != "__init__.py" and p.suffix == ".py")
        else:
            paths.append(pkg / s)
    return [p for p in paths if p.exists()]


def info(p: pathlib.Path):
    tree = ast.parse(p.read_text())
    doc = (ast.get_docstring(tree) or "").strip().split("\n")[0]
    alls = []
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", "") == "__all__" for t in node.targets):
            try:
                alls = [e.value for e in node.value.elts]
            except Exception:
                pass
    return doc, alls


def main():
    print("# API index\n")
    print("Every module with its public surface (`__all__`) — generated "
          "from\nsource; regenerate with the snippet at the bottom. One "
          "line per\nmodule: what it is and what it exports.\n")
    seen = set()
    for title, spec in GROUPS:
        print(f"## {title}\n")
        print("| Module | Summary | Exports |")
        print("|---|---|---|")
        for p in expand(spec):
            if p in seen:
                continue
            seen.add(p)
            doc, alls = info(p)
            ex = ", ".join(f"`{a}`" for a in alls) if alls else "—"
            rel = p.relative_to(ROOT / "nr3d_lib_tpu")
            print(f"| `{rel}` | {doc} | {ex} |")
        print()
    print("## Regenerating\n\n```\npython docs/gen_api_index.py > "
          "docs/API.md\n```")


if __name__ == "__main__":
    main()
