"""String-keyed allocator backend registry.

Every backend registers itself at import time (``@register(...)`` on the
class); consumers look it up by name:

    from repro.alloc import registry
    allocator = registry.create("gmlake", device)

or hand any consumer the key directly — ``trace.replay(trace, "stalloc")``,
``Arena(cfg, allocator="caching")``, ``benchmarks/run.py --allocator
stalloc`` all resolve through here. Registering a new backend is one
decorator; nothing in the replay/serve/bench layers changes.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Type, Union

from .protocol import AllocatorCapabilities, AllocatorProtocol

#: name -> backend class. Insertion order is registration order; the
#: built-ins register caching, native, gmlake, stalloc (in module-import
#: order), so iteration is stable for tests and benchmark tables.
_BACKENDS: Dict[str, type] = {}


def register(
    name: str, capabilities: Optional[AllocatorCapabilities] = None
) -> Callable[[type], type]:
    """Class decorator: register an allocator backend under ``name``.

    The class must satisfy ``AllocatorProtocol`` and take
    ``(device, *, record_timeline=False, **backend_kwargs)``. If
    ``capabilities`` is not given, the class must carry its own
    ``capabilities`` class attribute.
    """

    def deco(cls: type) -> type:
        if capabilities is not None:
            cls.capabilities = capabilities
        if getattr(cls, "capabilities", None) is None:
            raise ValueError(f"backend {name!r} declares no capabilities")
        if name in _BACKENDS and _BACKENDS[name] is not cls:
            raise ValueError(f"backend name {name!r} already registered")
        cls.name = name
        _BACKENDS[name] = cls
        return cls

    return deco


def names() -> List[str]:
    """Registered backend names, registration order."""
    return list(_BACKENDS)


def get(name: str) -> type:
    """The backend class for ``name``; KeyError lists valid names."""
    try:
        return _BACKENDS[name]
    except KeyError:
        raise KeyError(
            f"unknown allocator backend {name!r}; registered: {', '.join(_BACKENDS)}"
        ) from None


def capabilities(backend: Union[str, AllocatorProtocol, type]) -> AllocatorCapabilities:
    """Capability flags for a backend name, class, or instance."""
    if isinstance(backend, str):
        backend = get(backend)
    return backend.capabilities


def with_capability(flag: str) -> List[str]:
    """Backend names whose declared capabilities set ``flag`` truthy.

    The generic way for consumers (fault benches, conformance tests) to
    select e.g. every ``recovery`` backend without hardcoding names.
    """
    return [n for n, cls in _BACKENDS.items() if getattr(cls.capabilities, flag, False)]


def create(name: str, device, record_timeline: bool = False, **kwargs):
    """Instantiate backend ``name`` over ``device``."""
    return get(name)(device, record_timeline=record_timeline, **kwargs)


def resolve(
    allocator: Union[str, AllocatorProtocol],
    device_factory: Callable[[], object],
    record_timeline: bool = False,
    **kwargs,
):
    """A backend instance from either a registry key or an instance.

    Strings construct a fresh backend over ``device_factory()``; instances
    pass through untouched (their device and options are already bound) —
    passing construction options alongside an instance is rejected rather
    than silently dropped. This is the one conversion point every
    backend-generic consumer uses.
    """
    if isinstance(allocator, str):
        return create(allocator, device_factory(), record_timeline, **kwargs)
    if record_timeline or kwargs:
        opts = ["record_timeline"] if record_timeline else []
        opts += sorted(kwargs)
        raise ValueError(
            f"allocator options {opts} were passed with an already-"
            f"constructed {allocator.name!r} instance; construct the "
            f"backend with them, or pass the registry key instead"
        )
    return allocator


__all__ = [
    "register",
    "names",
    "get",
    "capabilities",
    "with_capability",
    "create",
    "resolve",
]
