"""API-superset regression check against the reference package.

Parses `/root/reference/cmfrec/__init__.py` with `ast` (never imported —
the reference's compiled extension isn't built here) and asserts that every
public class, every public method, every method argument, and every
constructor argument the reference exposes also exists in cmfrec_tpu.
This pins the "verified full superset" claim as a
test: dropping any argument fails CI.  Skipped when the reference tree is
not present (e.g. when this repo is used standalone).
"""

import ast
import inspect
import os

import pytest

REF_INIT = "/root/reference/cmfrec/__init__.py"

PUBLIC_CLASSES = [
    "CMF",
    "CMF_implicit",
    "OMF_explicit",
    "OMF_implicit",
    "ContentBased",
    "MostPopular",
    "CMF_imputer",
]

# Reference methods that are deliberately absent, with the recorded reason.
# (Nothing is currently waived; keep the mechanism so future waivers are
# explicit and reviewable.)
WAIVED_METHODS: dict = {}
# Arguments deliberately renamed (reference name -> ours); none today.
WAIVED_ARGS: dict = {}


def _ref_class_specs():
    with open(REF_INIT) as f:
        tree = ast.parse(f.read())
    by_name = {n.name: n for n in tree.body if isinstance(n, ast.ClassDef)}

    def mro_bodies(name):
        """Class body plus base-class bodies (single inheritance chains
        within the module: _CMF, _OMF_Base, _OMF)."""
        out = []
        while name in by_name:
            node = by_name[name]
            out.append(node)
            bases = [b.id for b in node.bases if isinstance(b, ast.Name)]
            name = bases[0] if bases else None
        return out

    specs = {}
    for cname in PUBLIC_CLASSES:
        methods = {}
        for node in mro_bodies(cname):
            for item in node.body:
                if not isinstance(item, ast.FunctionDef):
                    continue
                if item.name.startswith("_") and item.name != "__init__":
                    continue
                if item.name in methods:  # nearest override wins
                    continue
                args = [a.arg for a in item.args.args if a.arg != "self"]
                args += [a.arg for a in item.args.kwonlyargs]
                methods[item.name] = args
        specs[cname] = methods
    return specs


@pytest.mark.skipif(not os.path.exists(REF_INIT),
                    reason="reference tree not available")
@pytest.mark.parametrize("cname", PUBLIC_CLASSES)
def test_api_is_superset_of_reference(cname):
    import cmfrec_tpu

    specs = _ref_class_specs()
    ours = getattr(cmfrec_tpu, cname)
    missing = []
    for mname, ref_args in specs[cname].items():
        if WAIVED_METHODS.get(cname, {}).get(mname):
            continue
        target = ours.__init__ if mname == "__init__" else getattr(
            ours, mname, None)
        if target is None:
            missing.append(f"{cname}.{mname} (method absent)")
            continue
        try:
            sig = inspect.signature(target)
        except (TypeError, ValueError):
            continue
        params = set(sig.parameters)
        has_kwargs = any(p.kind is inspect.Parameter.VAR_KEYWORD
                         for p in sig.parameters.values())
        for arg in ref_args:
            arg = WAIVED_ARGS.get(cname, {}).get(arg, arg)
            if arg not in params and not has_kwargs:
                missing.append(f"{cname}.{mname}(..., {arg})")
    assert not missing, "reference API elements absent:\n" + "\n".join(missing)
