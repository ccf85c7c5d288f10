"""``schema_method`` — annotate service methods with a callable schema.

The reference's app services expose ``@schema_method`` functions whose
signatures/docstrings become JSON schemas for agent consumption (the
hypha-rpc convention; the proxy wraps one schema_function per entry
method, ref bioengine/apps/proxy_deployment.py:477-597). Same contract
here: decorate a method, and the service layer publishes its schema.
"""

from __future__ import annotations

import inspect
from typing import Any, Callable, get_type_hints

_TYPE_MAP = {
    int: "integer",
    float: "number",
    str: "string",
    bool: "boolean",
    list: "array",
    dict: "object",
    bytes: "string",
    type(None): "null",
}


def extract_schema(func: Callable) -> dict[str, Any]:
    sig = inspect.signature(func)
    try:
        hints = get_type_hints(func)
    except Exception:
        hints = {}
    properties: dict[str, Any] = {}
    required: list[str] = []
    for name, param in sig.parameters.items():
        if name in ("self", "cls", "context"):
            continue
        prop: dict[str, Any] = {}
        hint = hints.get(name)
        if hint in _TYPE_MAP:
            prop["type"] = _TYPE_MAP[hint]
        if param.default is not inspect.Parameter.empty:
            prop["default"] = param.default
        else:
            if param.kind not in (
                inspect.Parameter.VAR_POSITIONAL,
                inspect.Parameter.VAR_KEYWORD,
            ):
                required.append(name)
        properties[name] = prop
    return {
        "name": func.__name__,
        "description": inspect.getdoc(func) or "",
        "parameters": {
            "type": "object",
            "properties": properties,
            "required": required,
        },
    }


def schema_method(func: Callable) -> Callable:
    """Mark a method as a published service endpoint with a schema."""
    func.__schema__ = extract_schema(func)
    func.__is_schema_method__ = True
    return func


def is_schema_method(func: Any) -> bool:
    return callable(func) and getattr(func, "__is_schema_method__", False)
