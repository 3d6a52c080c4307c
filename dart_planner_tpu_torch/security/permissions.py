"""Centralized role-based access control (RBAC) (PyTorch counterpart
of :mod:`dart_planner_tpu.security.permissions`).

Parity rebuild of the reference's permission registry
(the reference's security/permissions.py:1-304): one
module owns every permission and the role->permission matrix, so access
rules are never duplicated across the gateway, the secure hardware
channel, and user management.

Design differs from the reference's hand-enumerated sets: permissions
are ``domain:action`` pairs generated from a compact domain spec, and
role grants are rules over domains — the full matrix is derived, so
adding an action to a domain automatically propagates to every role
granted that domain.
"""

from __future__ import annotations

import enum
from typing import Dict, FrozenSet, Iterable, List, Set

from dart_planner_tpu_torch.security.auth import Role

# --- domain -> actions spec (the single source of truth) ---
_DOMAINS: Dict[str, tuple] = {
    "user": ("create", "read", "update", "delete", "manage_roles"),
    "config": ("read", "update", "delete"),
    "flight": (
        "arm", "disarm", "takeoff", "land", "emergency_stop",
        "set_mode", "position", "velocity", "attitude",
    ),
    "mission": (
        "create", "read", "update", "delete", "upload",
        "start", "pause", "stop",
    ),
    "monitor": ("telemetry", "status", "logs_read", "logs_write"),
    "hardware": ("connect", "disconnect", "config_read", "config_update"),
    "security": ("audit_read", "audit_write", "keys_manage"),
}

Permission = enum.Enum(
    "Permission",
    {
        f"{domain}_{action}".upper(): f"{domain}:{action}"
        for domain, actions in _DOMAINS.items()
        for action in actions
    },
    type=str,
)
Permission.__doc__ = "Every permission in the system, as domain:action."


def _grant(*rules) -> FrozenSet[Permission]:
    """Expand grant rules: "domain" = every action in the domain,
    "domain:action" = that one permission."""
    out: Set[Permission] = set()
    for rule in rules:
        if ":" in rule:
            out.add(Permission(rule))
        else:
            out.update(
                Permission(f"{rule}:{a}") for a in _DOMAINS[rule]
            )
    return frozenset(out)


# --- the role matrix (reference permissions.py:69-185 semantics) ---
ROLE_MATRIX: Dict[Role, FrozenSet[Permission]] = {
    # admins hold everything
    Role.ADMIN: _grant(*_DOMAINS),
    # pilots fly: full flight + mission authority, monitoring reads,
    # hardware session control, no user/security administration
    Role.PILOT: _grant(
        "flight", "mission",
        "monitor:telemetry", "monitor:status", "monitor:logs_read",
        "hardware:connect", "hardware:disconnect", "hardware:config_read",
    ),
    # operators manage missions and may only STOP the vehicle
    Role.OPERATOR: _grant(
        "mission", "flight:emergency_stop",
        "monitor:telemetry", "monitor:status", "monitor:logs_read",
        "hardware:config_read",
    ),
    # viewers observe
    Role.VIEWER: _grant(
        "monitor:telemetry", "monitor:status", "monitor:logs_read"
    ),
}

PERMISSION_GROUPS: Dict[str, FrozenSet[Permission]] = {
    domain: _grant(domain) for domain in _DOMAINS
}


def get_role_permissions(role: Role) -> FrozenSet[Permission]:
    return ROLE_MATRIX.get(role, frozenset())


def has_permission(role: Role, permission: Permission) -> bool:
    return permission in get_role_permissions(role)


def has_any_permission(role: Role, permissions: Iterable[Permission]) -> bool:
    granted = get_role_permissions(role)
    return any(p in granted for p in permissions)


def has_all_permissions(role: Role, permissions: Iterable[Permission]) -> bool:
    granted = get_role_permissions(role)
    return all(p in granted for p in permissions)


def get_permissions_by_group(group: str) -> FrozenSet[Permission]:
    return PERMISSION_GROUPS.get(group, frozenset())


def get_roles_with_permission(permission: Permission) -> List[Role]:
    return [r for r in Role if has_permission(r, permission)]


# --- legacy string permissions (security.auth.ROLE_PERMISSIONS uses
# short command strings; the secure hardware channel keys off them,
# hardware/secure_interface.py) ---
LEGACY_PERMISSION_MAP: Dict[str, FrozenSet[Permission]] = {
    "arm": _grant("flight:arm"),
    "disarm": _grant("flight:disarm"),
    "takeoff": _grant("flight:takeoff"),
    "land": _grant("flight:land"),
    "emergency_stop": _grant("flight:emergency_stop"),
    "set_mission": _grant("mission"),
    "view": _grant(
        "monitor:telemetry", "monitor:status", "monitor:logs_read"
    ),
}


def has_legacy_permission(role: Role, permission_string: str) -> bool:
    """True when the role holds ANY permission the legacy string maps
    to (reference permissions.py:286-304 semantics)."""
    return has_any_permission(
        role, LEGACY_PERMISSION_MAP.get(permission_string, frozenset())
    )
