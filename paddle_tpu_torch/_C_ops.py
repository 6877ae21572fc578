"""The flat op namespace (counterpart of paddle_tpu/_C_ops.py): each name
of the reference's op inventory resolves to the port's registered
function of that name (``core.dispatch.WRAPPERS``); a name the port has
not ported raises ``AttributeError`` naming the ROADMAP.md item it waits
for (``ops.coverage.WAITING``)."""


def __getattr__(name):
    from .core.dispatch import WRAPPERS
    from .ops import coverage

    coverage.load_all()
    fn = WRAPPERS.get(name)
    if fn is None:
        item = coverage.WAITING.get(name)
        raise AttributeError(
            "paddle_tpu_torch._C_ops has no op %r%s" % (
                name, "" if item is None else
                " (not ported yet: ROADMAP.md %s)" % item))
    globals()[name] = fn
    return fn
