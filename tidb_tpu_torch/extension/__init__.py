# ported from tidb_tpu/extension/__init__.py @ 9be2bf6
"""Extension points: compile-time extension registry.

Reference analog: pkg/extension (extensions.go Registry + manifest) —
unlike runtime plugins (tidb_tpu_torch/plugin, .so-style audit hooks), an
extension registers BEFORE domains boot and can extend the engine
surface itself: bootstrap logic run at Domain init, extra system
variables, custom scalar SQL functions, and session lifecycle hooks.

    from tidb_tpu_torch import extension

    def frob(x):                # custom scalar function
        return x * 2 + 1

    extension.register(
        "my-ext",
        bootstrap=lambda dom: dom.sysvars.setdefault("my_ext_mode", "on"),
        functions={"frob": (frob, 1)},
        session_hooks=my_audit_obj,          # plugin-style hook object
        sysvars=[("my_ext_flag", 1)],
    )

Extensions registered after a Domain booted apply to the NEXT domain
(setup is checked once per Domain, like the reference's once-per-process
manifest setup).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Optional


@dataclass
class Extension:
    name: str
    bootstrap: Optional[Callable] = None      # (domain) -> None
    functions: dict = field(default_factory=dict)   # name -> (fn, arity)
    session_hooks: Any = None                 # plugin-style hook object
    sysvars: list = field(default_factory=list)     # [(name, default)]


class ExtensionRegistry:
    def __init__(self):
        self._exts: dict[str, Extension] = {}
        self._mu = threading.Lock()

    def register(self, name: str, **kw) -> Extension:
        ext = Extension(name, **kw)
        with self._mu:
            if name in self._exts:
                raise ValueError(f"extension {name!r} already registered")
            self._exts[name] = ext
        return ext

    def unregister(self, name: str) -> bool:
        with self._mu:
            return self._exts.pop(name, None) is not None

    def extensions(self) -> list:
        with self._mu:
            return list(self._exts.values())

    def setup_domain(self, dom) -> None:
        """Apply every registered extension to a booting Domain
        (extension.Registry.Bootstrap analog)."""
        from ..plugin import registry as plugin_registry
        for ext in self.extensions():
            for nm, default in ext.sysvars:
                dom.sysvars.setdefault(nm.lower(), default)
            if ext.session_hooks is not None:
                if not getattr(ext.session_hooks, "name", ""):
                    ext.session_hooks.name = f"ext:{ext.name}"
                if all(p.name != ext.session_hooks.name
                       for p in plugin_registry.plugins()):
                    plugin_registry.register(ext.session_hooks)
            for nm, (fn, arity) in ext.functions.items():
                _register_function(nm, fn, arity)
            if ext.bootstrap is not None:
                ext.bootstrap(dom)


def _register_function(name: str, fn: Callable, arity: int) -> None:
    """Expose a host scalar function to SQL (extension function point:
    pkg/extension RegisterExtensionFunc).  Runs row-at-a-time on host via
    the host evaluator's python-function escape (the port keeps the
    table in ``expr/host_eval``)."""
    from ..expr import host_eval as _host_eval
    _host_eval.EXTENSION_FUNCS[name.lower()] = (fn, arity)


registry = ExtensionRegistry()


def register(name: str, **kw) -> Extension:
    return registry.register(name, **kw)


__all__ = ["Extension", "ExtensionRegistry", "register", "registry"]
