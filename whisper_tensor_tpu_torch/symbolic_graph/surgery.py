"""Graph surgery utilities (reference: SymbolicGraphMutator,
src/symbolic_graph/mod.rs).

`replace_ids_with_embeds` derives an `inputs_embeds` entry point from
any LLM step graph: the token-embedding Gather is cut out and its
output becomes a graph input, so fused image/text embedding sequences
drive the SAME weights and KV-cache layout as the token path
(reference MultimodalLanguageInterface contract,
src/interfaces.rs:185-327). The returned graph SHARES the TensorStore
(weights are not copied — both graphs feed from the same device
buffers).

The port's copy of whisper_tensor_tpu/symbolic_graph/surgery.py,
unchanged; the multimodal interface runs the derived graph with the
text interface's passes and device weights
(interfaces/multimodal.py).
"""

from __future__ import annotations

from dataclasses import replace as dc_replace
from typing import Optional

from ..graph import new_global_id
from ..tensor_info import TensorInfo
from .ir import SOp, STensor, SymbolicGraph, TensorKind


def clone_graph(g: SymbolicGraph, name: Optional[str] = None) -> SymbolicGraph:
    """Structural copy sharing the TensorStore, resolver, and Operation
    objects (all immutable in practice); tensors and op wiring are
    fresh so surgery never mutates the source graph."""
    out = SymbolicGraph(name or (g.name + "_clone"), resolver=g.resolver,
                        store=g.store, opsets=dict(g.opsets))
    out.tensors = {tid: dc_replace(t) for tid, t in g.tensors.items()}
    out.by_name = dict(g.by_name)
    out.ops = [SOp(op.id, op.name, op.op, list(op.inputs), list(op.outputs))
               for op in g.ops]
    out.inputs = list(g.inputs)
    out.outputs = list(g.outputs)
    return out


def replace_ids_with_embeds(g: SymbolicGraph, ids_name: str = "input_ids",
                            embeds_name: str = "inputs_embeds",
                            ) -> SymbolicGraph:
    """Return a clone of `g` whose token-embedding lookup is replaced by
    a graph input `embeds_name` of shape (batch, seq, E).

    Rules:
      * the Gather(embedding_table, input_ids) op is deleted; consumers
        of its output read the new input instead
      * other consumers of input_ids must be shape-only ops (Shape) —
        they are retargeted to inputs_embeds, whose first two dims match
      * raises ValueError when input_ids feeds anything value-dependent
    """
    out = clone_graph(g, g.name + "_embeds")
    if ids_name not in out.by_name:
        raise ValueError(f"graph has no input {ids_name!r}")
    ids_tid = out.by_name[ids_name]

    gather = None
    for sop in out.ops:
        if sop.op.OP_TYPE == "Gather" and len(sop.inputs) >= 2 \
                and sop.inputs[1] == ids_tid:
            data_tid = sop.inputs[0]
            if out.tensors[data_tid].kind is TensorKind.INITIALIZER:
                gather = sop
                break
    if gather is None:
        raise ValueError(
            f"no Gather(<initializer>, {ids_name}) found — cannot derive "
            f"an {embeds_name} entry for this graph")

    tok_tid = gather.outputs[0]
    table = out.tensors[gather.inputs[0]]
    emb_dim = None
    if table.info is not None and table.info.dims() is not None:
        d = table.info.dims()[-1]
        emb_dim = int(d.value()) if d.is_known else None
    dtype = out.tensors[tok_tid].dtype or table.dtype

    # new input, typed (batch, seq, E)
    info = TensorInfo.shaped(dtype, [
        out._dim("batch"), out._dim("seq"),
        out._dim(emb_dim if emb_dim is not None else "embed")])
    emb_tid = new_global_id()
    out.tensors[emb_tid] = STensor(emb_tid, embeds_name, dtype, info,
                                   TensorKind.INPUT)
    out.by_name[embeds_name] = emb_tid

    # rewire: tok -> inputs_embeds, delete the gather
    out.replace_tensor(tok_tid, emb_tid)
    out.remove_op(gather)
    out.tensors.pop(tok_tid, None)

    # retarget remaining ids consumers (shape-only) to the new input;
    # only Shape slices fully inside dims [0, 2) transfer safely from
    # (B,S) to (B,S,E)
    for sop in out.consumers_of(ids_tid):
        op = sop.op
        if op.OP_TYPE != "Shape" or getattr(op, "start", 0) < 0 \
                or getattr(op, "end", None) is None \
                or not (0 <= op.start <= op.end <= 2):
            raise ValueError(
                f"{ids_name} feeds op {sop.op.OP_TYPE!r} whose semantics "
                f"change under (B,S,E); cannot derive {embeds_name} entry")
        sop.inputs = [emb_tid if i == ids_tid else i for i in sop.inputs]

    out.inputs = [emb_tid if t == ids_tid else t for t in out.inputs]
    out.by_name.pop(ids_name, None)
    out.tensors.pop(ids_tid, None)
    return out
