import pytest

from direct12pbrrenderer.graph import frame_graph as fg


def P(name, reads, writes, fn=None):
    return fg.RenderPass(name, tuple(reads), tuple(writes),
                         fn or (lambda env: {w: env.get(w, 0) for w in writes}))


def test_topological_order_from_reads_writes():
    passes = [
        P("present", ["final"], ["backbuffer"]),
        P("tonemap", ["rt"], ["final"]),
        P("shade", ["gbuf"], ["rt"]),
        P("gbuffer", [], ["gbuf"]),
    ]
    g = fg.compile_graph(passes, present="present")
    names = [p.name for p in g.order]
    assert names == ["gbuffer", "shade", "tonemap", "present"]


def test_write_write_ordering_follows_registration():
    """Two writers of the same resource keep registration order (skybox after
    deferred shading; bloom after both), like command order in the reference."""
    passes = [
        P("shade", ["gbuf"], ["rt"]),
        P("skybox", [], ["rt"]),
        P("bloom", ["rt"], ["rt"]),
        P("present", ["rt"], ["bb"]),
        P("gbuffer", [], ["gbuf"]),
    ]
    g = fg.compile_graph(passes, present="present")
    names = [p.name for p in g.order]
    assert names.index("shade") < names.index("skybox") < names.index("bloom")
    assert names[-1] == "present"


def test_cycle_detected():
    passes = [
        P("a", ["y"], ["x"]),
        P("b", ["x"], ["y"]),
        P("present", ["x"], ["bb"]),
    ]
    with pytest.raises(fg.GraphError, match="cycle"):
        fg.compile_graph(passes, present="present")


def test_unused_pass_rejected():
    passes = [
        P("orphan", [], ["unused"]),
        P("present", [], ["bb"]),
    ]
    with pytest.raises(fg.GraphError, match="not reachable"):
        fg.compile_graph(passes, present="present")


def test_lifetimes_and_donation():
    passes = [
        P("gbuffer", [], ["gbuf"]),
        P("shade", ["gbuf"], ["rt"]),
        P("tonemap", ["rt"], ["final"]),
        P("present", ["final"], ["bb"]),
    ]
    g = fg.compile_graph(passes, present="present")
    assert g.lifetimes["gbuf"] == (0, 1)
    assert g.lifetimes["rt"] == (1, 2)
    # gbuf dies after pass 1 (shade), rt after 2 -> donatable
    assert "gbuf" in g.donatable[1]
    assert "rt" in g.donatable[2]


def test_execute_runs_and_validates():
    log = []

    def mk(name, reads, writes):
        def fn(env):
            log.append(name)
            return {w: name for w in writes}

        return fg.RenderPass(name, tuple(reads), tuple(writes), fn)

    passes = [
        mk("present", ("x",), ("bb",)),
        mk("producer", (), ("x",)),
    ]
    g = fg.compile_graph(passes, present="present")
    out = fg.execute(g, {})
    assert log == ["producer", "present"]
    assert out["bb"] == "present"

    bad = fg.RenderPass("bad", (), ("a",), lambda env: {"a": 1, "sneaky": 2})
    g2 = fg.compile_graph([bad, mk("present", ("a",), ("bb",))], present="present")
    with pytest.raises(fg.GraphError, match="wrote undeclared"):
        fg.execute(g2, {})


def test_description_table_redeclaration_mismatch():
    """FGResourceDescriptionTable semantics (FrameGraphResource.h:191-209):
    the same resource declared by two passes must carry identical descs."""
    import numpy as np

    d1 = fg.ResourceDesc((4, 4, 3), "float32")
    d2 = fg.ResourceDesc((4, 4, 4), "float32")
    producer = fg.RenderPass(
        "producer", (), ("rt",),
        lambda env: {"rt": np.zeros((4, 4, 3), np.float32)},
        declares={"rt": d1},
    )
    consumer_ok = fg.RenderPass(
        "present", ("rt",), ("bb",), lambda env: {"bb": env["rt"]},
        declares={"rt": d1},
    )
    g = fg.compile_graph([producer, consumer_ok], present="present")
    assert g.descriptions["rt"] == d1
    fg.execute(g, {})

    consumer_bad = fg.RenderPass(
        "present", ("rt",), ("bb",), lambda env: {"bb": env["rt"]},
        declares={"rt": d2},
    )
    with pytest.raises(fg.GraphError, match="mismatched description"):
        fg.compile_graph([producer, consumer_bad], present="present")


def test_description_table_production_mismatch():
    """A pass producing an array that violates its own declaration is a
    named graph error, not an opaque downstream XLA shape error."""
    import numpy as np

    producer = fg.RenderPass(
        "producer", (), ("rt",),
        lambda env: {"rt": np.zeros((2, 2, 4), np.float32)},  # wrong shape
        declares={"rt": fg.ResourceDesc((4, 4, 3), "float32")},
    )
    present = fg.RenderPass(
        "present", ("rt",), ("bb",), lambda env: {"bb": env["rt"]}
    )
    g = fg.compile_graph([producer, present], present="present")
    with pytest.raises(fg.GraphError, match="produced 'rt'"):
        fg.execute(g, {})
