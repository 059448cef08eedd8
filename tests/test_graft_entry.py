"""Driver entry points (__graft_entry__.py) stay in sync with the pipeline.

entry()'s example args must trace against the pipeline's actual _frame
signature (it silently broke when the packed per-frame upload landed — this
pins it; the driver compile-checks the same call on hardware)."""

import pathlib
import sys

import jax

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def test_entry_traces():
    import __graft_entry__ as g

    fn, args = g.entry()
    shapes = jax.eval_shape(fn, *args)
    leaves = jax.tree_util.tree_leaves(shapes)
    assert leaves, "entry() returned nothing traceable"
    # first output is the uint8 back buffer
    img = shapes[0] if isinstance(shapes, tuple) else leaves[0]
    assert img.shape[-1] == 3 and img.dtype.name == "uint8"
