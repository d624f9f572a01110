from . import mathx  # noqa: F401
