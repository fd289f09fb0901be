"""Sequence parallelism for training: each rank's share of the tokens.

The port's own pass. In the JAX package the trainer places the batch's
sequence dimension over the mesh's `sp` axis (training/trainer.py:
330-337) and GSPMD partitions the traced graph around that placement.
Eager PyTorch has no partitioner, so `shard_sequence` rewrites the
training graph (input_ids (B, S) -> logits (B, S, V)) for ranks that each
hold S/sp consecutive tokens, at index i of `sp` the tokens [i*S/sp,
(i+1)*S/sp):
  * the token-wise work (products, norms, the MLP, the head) runs as it
    is, on the rank's tokens;
  * an Attention node takes the whole sequence's keys and values: k and
    v are gathered along their sequence dimension over `sp` (AllGather;
    comm.all_gather's backward sums the slices' gradients, since each
    rank's loss is a term of the whole loss); a causal Attention becomes
    one under a rank-0 position mask at the rank's first position (query
    row s sees keys j <= i*S/sp + s), where the node's own causal mode
    would offset by Skv - Sq, which is right only for the last rank;
  * positions are global: a Range whose output indexes a table (GPT-2's
    wpe[arange(S)]) is shifted by the rank's first position, and a
    Rotary node without position ids is given them (llama's rope at
    absolute positions).
The loss is the trainer's: its mean over the global token count
(training/trainer.py). Runs after the tp pass (parallel/tp.py) where
both cut a mesh.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass

import numpy as np
import torch

from ..graph import new_global_id
from ..milli.ir import MilliGraph, MilliNode, MilliOp
from ..milli.ops.basic import Constant, SimpleBinary
from ..milli.registry import lowering
from .mesh import Mesh
from .tp import AllGatherMilli


@dataclass
class SeqPositionsMilli(MilliOp):
    """The global positions of x's tokens along `dim`: offset + arange
    (x's extent there), int64."""

    offset: int = 0
    dim: int = 2
    KIND = "SeqPositions"

    def eval(self, inputs):
        n = np.asarray(inputs[0]).shape[self.dim]
        return [np.arange(self.offset, self.offset + n, dtype=np.int64)]


@lowering("SeqPositions")
def _seq_positions(op, inputs, static, device):
    n = inputs[0].shape[op.dim]
    return [torch.arange(op.offset, op.offset + n, dtype=torch.int64,
                         device=inputs[0].device)]


def shard_sequence(milli: MilliGraph, mesh: Mesh, tokens: int,
                   axis: str = "sp") -> MilliGraph:
    """This rank's training graph when the tokens are cut over `axis`:
    `tokens` is the rank's count (S / sp), which places its first
    position. The graph is copied; `milli` is not changed."""
    g = copy.deepcopy(milli)
    offset = mesh.index(axis) * int(tokens)
    gathers_of = {}
    consumers = {}
    for node in g.nodes:
        for i in node.inputs:
            if i is not None:
                consumers.setdefault(i, []).append(node)
    nodes = []

    def add(op: MilliOp, inputs, label=None) -> int:
        out = g.new_tensor(label=label)
        nodes.append(MilliNode(new_global_id(), op, list(inputs), [out]))
        return out

    def gathered(tid: int, dim: int) -> int:
        if (tid, dim) not in gathers_of:
            gathers_of[(tid, dim)] = add(
                AllGatherMilli(mesh=mesh, axis=axis, dim=dim), [tid])
        return gathers_of[(tid, dim)]

    for node in g.nodes:
        kind = node.op.KIND
        if kind == "Attention":
            op = node.op
            ins = list(node.inputs)
            if len(ins) > 4 and any(i is not None for i in ins[4:]):
                raise NotImplementedError(
                    f"sequence parallelism over an Attention node with "
                    f"past keys (node {node.id})")
            if len(ins) > 3 and ins[3] is not None:
                raise NotImplementedError(
                    f"sequence parallelism over an Attention node with a "
                    f"mask (node {node.id}): training graphs attend "
                    f"causally")
            # (B, H, S, D), or (B, S, H*D) when q_heads is set
            dim = 1 if op.q_heads else 2
            ins[1], ins[2] = gathered(ins[1], dim), gathered(ins[2], dim)
            if op.is_causal:
                pos = add(Constant(value=np.asarray(offset, np.int64)), [])
                ins = ins[:3] + [pos]
                node.op = copy.copy(op)
                node.op.is_causal = False
            node.inputs = ins
        elif kind == "Rotary" and (len(node.inputs) < 4
                                   or node.inputs[3] is None):
            dim = 1 if node.op.num_heads else 2
            pos = add(SeqPositionsMilli(offset=offset, dim=dim),
                      [node.inputs[0]])
            node.inputs = list(node.inputs[:3]) + [pos]
        elif kind == "Range" and any(
                c.op.KIND == "Gather" and len(c.inputs) > 1
                and c.inputs[1] == node.outputs[0]
                for c in consumers.get(node.outputs[0], ())):
            nodes.append(node)
            local = node.outputs[0]
            node.outputs = [g.new_tensor()]
            shift = add(Constant(value=np.asarray(offset, np.int64)), [])
            nodes.append(MilliNode(new_global_id(), SimpleBinary(mode="add"),
                                   [node.outputs[0], shift], [local]))
            continue
        nodes.append(node)
    g.nodes = nodes
    return g

