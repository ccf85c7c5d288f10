"""User/workspace permission checks for service methods.

Behavior parity with ref bioengine/utils/permissions.py:30-104 — a caller
context carries ``user: {id, email}`` and ``ws``; authorization lists may
contain ``"*"`` (any authenticated user), user ids, emails, or workspaces.
An empty/None authorization list denies every caller.
"""

from __future__ import annotations

from typing import Any, Iterable, Optional


class PermissionError_(PermissionError):
    """Raised when a caller is not authorized for a method."""


def create_context(
    user_id: str = "anonymous",
    email: Optional[str] = None,
    workspace: str = "public",
) -> dict[str, Any]:
    """Build the context dict passed to every service method."""
    return {
        "user": {"id": user_id, "email": email or f"{user_id}@local"},
        "ws": workspace,
    }


def check_permissions(
    context: Optional[dict[str, Any]],
    authorized_users: Optional[Iterable[str]],
    resource_name: str = "resource",
) -> None:
    """Raise PermissionError unless the context's user is authorized.

    Match order mirrors the reference: wildcard, user id, user email,
    workspace. Empty authorized list denies all.
    """
    if context is None or "user" not in context:
        raise PermissionError_(
            f"Missing user context for access to {resource_name}"
        )
    user = context["user"] or {}
    user_id = user.get("id")
    email = user.get("email")
    workspace = context.get("ws")

    allowed = list(authorized_users or [])
    if not allowed:
        raise PermissionError_(
            f"No users are authorized to access {resource_name}"
        )
    for entry in allowed:
        if entry == "*":
            return
        if user_id and entry == user_id:
            return
        if email and entry == email:
            return
        if workspace and entry == workspace:
            return
    raise PermissionError_(
        f"User '{user_id}' is not authorized to access {resource_name}"
    )


def check_method_permission(
    acl: "list | dict", method: str, context: Optional[dict]
) -> None:
    """Per-method ACL: method-specific entry > wildcard entry > deny
    (ref bioengine/apps/proxy_deployment.py:345-403)."""
    if isinstance(acl, dict):
        users = acl.get(method, acl.get("*"))
    else:
        users = acl
    check_permissions(context, users, resource_name=f"method '{method}'")


def is_authorized(
    context: Optional[dict[str, Any]], authorized_users: Optional[Iterable[str]]
) -> bool:
    try:
        check_permissions(context, authorized_users)
        return True
    except PermissionError:
        return False
