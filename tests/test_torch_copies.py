"""Each module the port keeps as a copy of the JAX package's is that module:
a ``recom_tpu_torch`` file headed "Port copy of recom_tpu/<path>", with
``recom_tpu_torch`` renamed back to ``recom_tpu`` and the header (the
comment lines up to the first that ends its sentence) dropped, is `==`
its source.  A copy whose header names further edits is held to exactly
those edits (``EDITS``); the host half of ``runtime/wire.py`` is held up to
the device-side unpack, which the port rewrote in torch."""

import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "recom_tpu_torch")
HEADER = re.compile(r"(#|//) Port copy of (recom_tpu/\S+?)[:,]")

# port file -> [(the source's text after the rename, or a pattern of it;
# the copy's)]: the edits its header names
EDITS = {
    "importers/__init__.py": [
        ("import (  # noqa: F401\n",
         "import (  # noqa: F401\n    import_params,\n"),
        ("    import_tf_saved_model,\n",
         "    import_tf_saved_model,\n    load_checkpoint_tables,\n"),
    ],
    "native/build.py": [
        ('    return os.environ.get(\n'
         '        "RECOM_TPU_CACHE_DIR", os.path.expanduser('
         '"~/.cache/recom_tpu")\n',
         '    # the port builds into its own git-ignored package directory\n'
         '    # (recom_tpu/build/), beside the CUDA kernel libraries\n'
         '    return os.path.join(\n'
         '        os.path.dirname(os.path.dirname(os.path.abspath('
         '__file__))), "build"\n'),
    ],
    "tools/tf_baseline.py": [
        ('os.environ.setdefault("CUDA_VISIBLE_DEVICES", "-1")\n', ""),
        ("    batch into that feed.\"\"\"\n    import tensorflow as tf\n",
         "    batch into that feed.\"\"\"\n    import tensorflow as tf\n\n"
         "    try:    # the TF-CPU baseline: keep TF off any card it can see\n"
         '        tf.config.set_visible_devices([], "GPU")\n'
         "    except (RuntimeError, ValueError):\n"
         "        pass    # TF's devices are already initialized (or it has "
         "no GPU)\n"),
    ],
    "tools/tf_sweep.py": [
        (re.compile(r"with engine host-prep timing on this single-core "
                    r"host \(\S+ run\nbenches alone\)\.\n"),
         "with the engine's host-prep timing.  It runs TF on the CPU only; "
         "nothing\nhere touches the card.\n"),
        ("--merge-into AE_SWEEP_r03.json", "--merge-into AE.json"),
        ("def main():", "def main(argv=None):"),
        ("ap.parse_args()", "ap.parse_args(argv)"),
    ],
}
# the copies kept up to a line: the rest is the port's own
HALVES = {"runtime/wire.py": "# Device-side unpack"}


def _copies():
    out = []
    for dirpath, dirs, files in os.walk(PORT):
        dirs[:] = sorted(d for d in dirs if d != "build")
        for f in sorted(files):
            if not f.endswith((".py", ".cc")):
                continue
            path = os.path.join(dirpath, f)
            with open(path) as fh:
                m = HEADER.match(fh.readline())
            if m:
                out.append((os.path.relpath(path, PORT), m.group(2)))
    return out


COPIES = _copies()


def _body(text: str) -> str:
    """``text`` without its header: the comment lines up to the first that
    ends with a full stop."""
    lines = text.splitlines(keepends=True)
    for i, line in enumerate(lines):
        if line.rstrip().endswith("."):
            return "".join(lines[i + 1:])
    raise AssertionError("the header never ends")


def test_every_copy_is_found_and_every_edit_names_a_copy():
    got = {rel for rel, _ in COPIES}
    assert len(got) >= 30
    assert set(EDITS) | set(HALVES) <= got
    for rel, src in COPIES:
        assert src == f"recom_tpu/{rel}", (rel, src)


@pytest.mark.parametrize("rel,src", COPIES, ids=[c[0] for c in COPIES])
def test_copy_equals_its_source(rel, src):
    with open(os.path.join(PORT, rel)) as f:
        body = _body(f.read()).replace("recom_tpu_torch", "recom_tpu")
    with open(os.path.join(ROOT, src)) as f:
        want = f.read()
    for old, new in EDITS.get(rel, ()):
        if isinstance(old, str):
            old = re.compile(re.escape(old))
        assert len(old.findall(want)) == 1, (rel, old.pattern)
        want = old.sub(lambda _: new, want)
    if rel in HALVES:
        cut = HALVES[rel]
        assert body.count(cut) == want.count(cut) == 1, rel
        body, want = body[:body.index(cut)], want[:want.index(cut)]
    assert body == want, f"{rel} differs from {src} beyond its header"
