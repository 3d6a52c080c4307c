"""User management CLI (PyTorch counterpart
of :mod:`dart_planner_tpu.security.manage_users`).

Parity port of the reference user-management tool
(the reference's security/manage_users.py — typer-based
create-admin / create-user / list-users / delete-user) on argparse
(without typer)::

    python -m dart_planner_tpu_torch.security.manage_users create-admin -u root -p pw
    python -m dart_planner_tpu_torch.security.manage_users create-user -u op -p pw -r operator
    python -m dart_planner_tpu_torch.security.manage_users list-users
    python -m dart_planner_tpu_torch.security.manage_users delete-user -u op
    python -m dart_planner_tpu_torch.security.manage_users set-role -u op -r admin
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional

from dart_planner_tpu_torch.security.auth import Role
from dart_planner_tpu_torch.security.db import UserService


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="manage_users")
    p.add_argument("--db", default="~/.dart_planner_tpu/users.db")
    sub = p.add_subparsers(dest="command", required=True)

    def user_args(sp, password=True, role=False):
        sp.add_argument("-u", "--username", required=True)
        if password:
            sp.add_argument("-p", "--password", required=True)
        if role:
            sp.add_argument(
                "-r", "--role", choices=[r.value for r in Role],
                default=Role.OPERATOR.value,
            )

    user_args(sub.add_parser("create-admin", help="create an admin user"))
    user_args(
        sub.add_parser("create-user", help="create a user"), role=True
    )
    sub.add_parser("list-users", help="list all users")
    user_args(
        sub.add_parser("delete-user", help="delete a user"), password=False
    )
    sp = sub.add_parser("set-role", help="change a user's role")
    user_args(sp, password=False, role=True)
    return p


def main(argv: Optional[list] = None, service: Optional[UserService] = None) -> int:
    args = build_parser().parse_args(argv)
    svc = service or UserService(args.db)
    if args.command == "create-admin":
        u = svc.create_user(args.username, args.password, Role.ADMIN)
        print(f"created admin {u['username']} (id {u['id']})")
    elif args.command == "create-user":
        u = svc.create_user(args.username, args.password, Role(args.role))
        print(f"created {u['role']} {u['username']} (id {u['id']})")
    elif args.command == "list-users":
        for u in svc.get_all_users():
            active = "active" if u["is_active"] else "disabled"
            print(f"{u['id']:>4}  {u['username']:<20} {u['role']:<10} {active}")
    elif args.command == "delete-user":
        u = svc.get_user_by_username(args.username)
        if u is None:
            print(f"no such user {args.username!r}", file=sys.stderr)
            return 1
        svc.delete_user(u["id"])
        print(f"deleted {args.username}")
    elif args.command == "set-role":
        u = svc.get_user_by_username(args.username)
        if u is None:
            print(f"no such user {args.username!r}", file=sys.stderr)
            return 1
        svc.update_user_role(u["id"], Role(args.role))
        print(f"{args.username} -> {args.role}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
