"""Cluster topology: node and node-group catalogs.

Equivalent of the reference's pgxc_node / pgxc_group catalogs and the node
manager (src/backend/pgxc/nodemgr/nodemgr.c:111 NodeTablesShmemInit,
groupmgr.c), driven by CREATE/ALTER/DROP NODE DDL (gram.y:307-313).

In the TPU build a "datanode" is an executor slot bound to a position along
the device mesh's 'dn' axis (one TPU chip or one per-host shard of devices),
a "coordinator" is a session-hosting frontend, and the GTM is the GTS
service. Names and DDL surface match the reference so admin workflows carry
over.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field


class NodeRole(enum.Enum):
    COORDINATOR = "coordinator"
    DATANODE = "datanode"
    GTM = "gtm"


@dataclass
class NodeDef:
    name: str
    role: NodeRole
    host: str = "localhost"
    port: int = 0
    is_primary: bool = False
    is_preferred: bool = False
    # Position on the device mesh 'dn' axis (datanodes only).
    mesh_index: int = -1


@dataclass
class NodeGroup:
    """A named subset of datanodes (pgxc_group). Default group holds all
    datanodes; cold/hot routing uses two groups: tables placed in a
    ``cold`` group resolve their node set to the group's members only,
    so cold scans never land a fragment on hot-set nodes."""

    name: str
    members: list[str] = field(default_factory=list)
    kind: str = "hot"  # hot | cold (pgxc_group's dual-group routing)


class NodeManager:
    def __init__(self):
        self._nodes: dict[str, NodeDef] = {}
        self._groups: dict[str, NodeGroup] = {}
        self._dn_order: list[str] = []
        self._next_mesh_index = 0  # never reused: mesh indices are stable

    def has(self, name: str) -> bool:
        return name in self._nodes

    def restore_datanode(self, name: str, mesh_index: int) -> NodeDef:
        """Recreate a datanode at its original stable mesh index (crash
        recovery only — normal DDL goes through create_node)."""
        node = NodeDef(name, NodeRole.DATANODE)
        node.mesh_index = mesh_index
        self._nodes[name] = node
        self._dn_order.append(name)
        self._next_mesh_index = max(self._next_mesh_index, mesh_index + 1)
        return node

    # -- DDL surface ----------------------------------------------------
    def create_node(self, node: NodeDef) -> None:
        if node.name in self._nodes:
            raise ValueError(f"node {node.name!r} already exists")
        if node.role == NodeRole.DATANODE:
            node.mesh_index = self._next_mesh_index
            self._next_mesh_index += 1
            self._dn_order.append(node.name)
        self._nodes[node.name] = node

    def drop_node(self, name: str, force: bool = False) -> None:
        """Drop a node. Datanode mesh indices are STABLE — dropping leaves a
        hole rather than renumbering, because ShardMap entries and table
        Locators hold mesh indices; renumbering would silently repoint
        shards at the wrong executors. Dropping a datanode requires the
        admin rebalance path to have emptied it first (MOVE DATA in the
        reference); pass force=True only when the caller has verified no
        shard map entry or table references the node."""
        node = self._nodes.get(name)
        if node is None:
            raise ValueError(f"node {name!r} does not exist")
        if node.role == NodeRole.DATANODE and not force:
            raise ValueError(
                f"cannot drop datanode {name!r}: move its shards first "
                "(MOVE DATA), then drop with force=True"
            )
        del self._nodes[name]
        if node.role == NodeRole.DATANODE:
            self._dn_order.remove(name)

    def alter_node(self, name: str, **kwargs) -> None:
        node = self.get(name)
        for k, v in kwargs.items():
            setattr(node, k, v)

    def create_group(
        self, name: str, members: list[str], kind: str = "hot"
    ) -> None:
        if kind not in ("hot", "cold"):
            raise ValueError(f"unknown node group kind {kind!r}")
        for m in members:
            if self.get(m).role != NodeRole.DATANODE:
                raise ValueError(f"group member {m!r} is not a datanode")
        self._groups[name] = NodeGroup(name, list(members), kind)

    def drop_group(self, name: str) -> None:
        if name not in self._groups:
            raise ValueError(f"group {name!r} does not exist")
        del self._groups[name]

    # -- lookups --------------------------------------------------------
    def get(self, name: str) -> NodeDef:
        if name not in self._nodes:
            raise ValueError(f"node {name!r} does not exist")
        return self._nodes[name]

    def group(self, name: str) -> NodeGroup:
        if name not in self._groups:
            raise ValueError(f"group {name!r} does not exist")
        return self._groups[name]

    def has_group(self, name: str) -> bool:
        return name in self._groups

    @property
    def datanodes(self) -> list[NodeDef]:
        return [self._nodes[n] for n in self._dn_order]

    @property
    def coordinators(self) -> list[NodeDef]:
        return [n for n in self._nodes.values() if n.role == NodeRole.COORDINATOR]

    @property
    def num_datanodes(self) -> int:
        return len(self._dn_order)

    def datanode_indices(self, group: str | None = None) -> list[int]:
        """Mesh indices of datanodes in a group (default: all). Mesh
        indices, not positions: after a REMOVE NODE the index space has
        holes, and a table created then must bind the live indices."""
        if group is None:
            return [self._nodes[n].mesh_index for n in self._dn_order]
        return [self.get(m).mesh_index for m in self.group(group).members]

    def all_groups(self) -> list[NodeGroup]:
        return list(self._groups.values())

    def group_of_index(self, mesh_index: int) -> NodeGroup | None:
        """First group containing the datanode at ``mesh_index`` (the
        EXPLAIN routing label; None = only implicit default group)."""
        for g in self._groups.values():
            for m in g.members:
                nd = self._nodes.get(m)
                if nd is not None and nd.mesh_index == mesh_index:
                    return g
        return None

    def all_nodes(self) -> list[NodeDef]:
        return list(self._nodes.values())
