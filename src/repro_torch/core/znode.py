"""ZooKeeper data-node (znode) model: paths, validation, op application.

System-store node items (key ``node:<path>``) carry:

  * ``data``            — authoritative payload (the user store holds replicas),
  * ``version``         — per-node monotone version (ZooKeeper ``dataVersion``),
  * ``cversion`` / ``cseq`` — children version / sequential-suffix counter,
  * ``children``        — list of child names,
  * ``ephemeral_owner`` — session id or ``None``,
  * ``created_txid`` / ``modified_txid`` — global txids (FaaSKeeper timestamps),
  * ``lock_ts``         — the timed-lock lease timestamp,
  * ``transactions``    — pending distributor txids (the writer's commit marker),
  * ``exists``          — tombstone flag (items persist so locks can be taken
    on paths that are being created/deleted, exactly like the paper's node
    list "to allow lock operations by writer functions", §4.4).

The mutators here are shared by the writer's commit-unlock and the
distributor's TryCommit so both apply byte-identical state transitions.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple


class FKError(Exception):
    code = "error"


class NoNodeError(FKError):
    code = "no_node"


class NodeExistsError(FKError):
    code = "node_exists"


class BadVersionError(FKError):
    code = "bad_version"


class NotEmptyError(FKError):
    code = "not_empty"


def validate_path(path: str) -> None:
    if not path.startswith("/") or (path != "/" and path.endswith("/")):
        raise FKError(f"invalid path {path!r}")
    if "//" in path:
        raise FKError(f"invalid path {path!r}")


def parent_path(path: str) -> str:
    if path == "/":
        return "/"
    p = path.rsplit("/", 1)[0]
    return p if p else "/"


def node_name(path: str) -> str:
    return path.rsplit("/", 1)[1]


def node_key(path: str) -> str:
    return f"node:{path}"


def fresh_node(path: str) -> Dict[str, Any]:
    return {
        "path": path,
        "exists": False,
        "data": b"",
        "version": -1,
        "cversion": 0,
        "cseq": 0,
        "children": [],
        "ephemeral_owner": None,
        "created_txid": 0,
        "modified_txid": 0,
        "lock_ts": None,
        "transactions": [],
    }


def live(item: Optional[Dict[str, Any]]) -> bool:
    return item is not None and bool(item.get("exists"))


# --------------------------------------------------------------------------
# Operation validation (writer step 2) and application (steps 4 / TryCommit)
# --------------------------------------------------------------------------


def sequential_name(path: str, cseq: int) -> str:
    return f"{path}{cseq:010d}"


def validate_op(
    op: str,
    args: Dict[str, Any],
    node: Optional[Dict[str, Any]],
    parent: Optional[Dict[str, Any]],
) -> Optional[str]:
    """Return an error code, or ``None`` if the operation is valid."""
    if op == "create":
        if live(node) and not args.get("sequence"):
            return NodeExistsError.code
        if not live(parent) and args["path"] != "/":
            return NoNodeError.code
        if parent is not None and parent.get("ephemeral_owner"):
            return "no_children_for_ephemerals"
        return None
    if op == "set_data":
        if not live(node):
            return NoNodeError.code
        v = args.get("version", -1)
        if v >= 0 and node["version"] != v:
            return BadVersionError.code
        return None
    if op == "delete":
        if not live(node):
            return NoNodeError.code
        v = args.get("version", -1)
        if v >= 0 and node["version"] != v:
            return BadVersionError.code
        if node.get("children"):
            return NotEmptyError.code
        return None
    if op == "deregister_session":
        return None
    raise FKError(f"unknown op {op}")


def apply_create(node: Dict[str, Any], args: Dict[str, Any], txid: int) -> None:
    node["exists"] = True
    node["data"] = args.get("data", b"")
    node["version"] = 0
    node["cversion"] = 0
    node["children"] = []
    node["ephemeral_owner"] = args.get("session") if args.get("ephemeral") else None
    node["created_txid"] = txid
    node["modified_txid"] = txid
    node["transactions"] = node.get("transactions", [])


def apply_parent_create(parent: Dict[str, Any], child: str, txid: int, sequence: bool) -> None:
    children = parent.setdefault("children", [])
    if child not in children:
        children.append(child)
    parent["cversion"] = parent.get("cversion", 0) + 1
    if sequence:
        parent["cseq"] = parent.get("cseq", 0) + 1
    parent["modified_txid"] = max(parent.get("modified_txid", 0), txid)


def apply_set_data(node: Dict[str, Any], args: Dict[str, Any], txid: int) -> None:
    node["data"] = args.get("data", b"")
    node["version"] = node.get("version", -1) + 1
    node["modified_txid"] = txid


def apply_delete(node: Dict[str, Any], txid: int) -> None:
    node["exists"] = False
    node["data"] = b""
    node["version"] = -1
    node["children"] = []
    node["ephemeral_owner"] = None
    node["modified_txid"] = txid


def apply_parent_delete(parent: Dict[str, Any], child: str, txid: int) -> None:
    children = parent.setdefault("children", [])
    if child in children:
        children.remove(child)
    parent["cversion"] = parent.get("cversion", 0) + 1
    parent["modified_txid"] = max(parent.get("modified_txid", 0), txid)


def materialize(
    op: str,
    args: Dict[str, Any],
    node_pre: Optional[Dict[str, Any]],
    parent_pre: Optional[Dict[str, Any]],
    txid: int,
) -> Tuple[Dict[str, Any], Optional[Dict[str, Any]]]:
    """Deterministically compute post-op node/parent state from pre-state.

    The writer pushes the *pre*-state snapshots (taken under the timed locks)
    to the distributor queue; both the writer's COMMITUNLOCK and the
    distributor's DATAUPDATE/TryCommit derive the post-state through this one
    function, so the system store and every regional user store apply
    byte-identical transitions — the substance of Single System Image (Ⓢ).
    """
    import copy as _copy

    path = args["path"]
    # Items created as a side effect of locking a not-yet-existing path carry
    # only the lease timestamp — normalize against fresh-node defaults.
    node = fresh_node(path)
    node.update(_copy.deepcopy(node_pre) or {})
    node["path"] = path
    parent = None
    if parent_pre is not None:
        parent = fresh_node(parent_path(path))
        parent.update(_copy.deepcopy(parent_pre))
    if op == "create":
        apply_create(node, args, txid)
        if parent is not None:
            apply_parent_create(parent, node_name(path), txid, bool(args.get("sequence")))
    elif op == "set_data":
        apply_set_data(node, args, txid)
    elif op == "delete":
        apply_delete(node, txid)
        if parent is not None:
            apply_parent_delete(parent, node_name(path), txid)
    else:  # pragma: no cover
        raise FKError(f"cannot materialize op {op}")
    for it in (node, parent) if parent is not None else (node,):
        it.pop("lock_ts", None)
        it.pop("transactions", None)
    return node, parent
