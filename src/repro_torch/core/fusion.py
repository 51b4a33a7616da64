"""Plan-level kernel fusion on op chains (paper §3.2 Fig. 7(c), §4 'Scheduling
Fully-Parallel with Fusion').

Rules, applied to a lowered stage list until fixpoint (the reference's rules 1-5;
rule 6 belongs to fused queries, not ported yet):

  1. FP -> FP        : concatenate chains (one kernel, no intermediate round-trip).
  2. FP -> GP.values : move the producer's chain into the Group-Parallel value
                       chain (bit-packed RLE values decode inside the expansion).
  3. GP -> FP        : append an elementwise consumer's ops to the GP tail.
  4. NP -> FP        : the same for the Non-Parallel tail (each decoded symbol
                       goes through the consumer's ops before it is written).
  5. FP -> Aux       : attach the producer to the auxiliary whole-array op; a
                       kernel backend still runs it as a kernel before the op.

A buffer may only be fused away if it has exactly one consumer and is not the plan's
final output.  Stage kinds, counts and names come out identical to the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.core.patterns import (Aux, FullyParallel, GroupParallel,
                                       NonParallel, Stage, compose_fp, load,
                                       stage_inputs)


def _use_counts(stages: Sequence[Stage]) -> dict[str, int]:
    uses: dict[str, int] = {}
    for st in stages:
        for name in stage_inputs(st):
            uses[name] = uses.get(name, 0) + 1
    return uses


def _fuse_once(stages: list[Stage], final_out: str | None) -> bool:
    """Apply the first applicable rewrite in place; False at fixpoint."""
    uses = _use_counts(stages)
    producer = {st.out: i for i, st in enumerate(stages)}

    def single_use(name: str) -> bool:
        return uses.get(name, 0) == 1 and name != final_out

    for ci, cons in enumerate(stages):
        # --- rule 1: FP -> FP ------------------------------------------------
        if isinstance(cons, FullyParallel) and cons.elementwise and cons.inputs:
            pi = producer.get(cons.inputs[0])
            if pi is not None and isinstance(stages[pi], FullyParallel) \
                    and single_use(stages[pi].out):
                stages[ci] = compose_fp(stages[pi], cons)
                del stages[pi]
                return True
        # --- rule 2: FP -> GP.values ----------------------------------------
        if isinstance(cons, GroupParallel) and cons.value_inputs:
            pi = producer.get(cons.value_inputs[0])
            if (pi is not None and isinstance(stages[pi], FullyParallel)
                    and len(cons.value_inputs) == 1 and cons.identity_values
                    and single_use(cons.value_inputs[0])):
                prod = stages[pi]
                stages[ci] = dataclasses.replace(
                    cons, value_inputs=prod.inputs, value_specs=prod.specs,
                    values=(prod.chain,), name=f"{prod.name}>{cons.name}",
                    identity_values=False)
                del stages[pi]
                return True
        # --- rules 3/4: GP|NP -> FP ------------------------------------------
        if isinstance(cons, FullyParallel) and cons.elementwise and cons.inputs:
            pi = producer.get(cons.inputs[0])
            if pi is not None and isinstance(stages[pi], (GroupParallel, NonParallel)):
                prod = stages[pi]
                # extra consumer inputs would need whole-buffer plumbing
                if single_use(prod.out) and len(cons.inputs) == 1 \
                        and cons.chain[0] == load(prod.out):
                    stages[ci] = dataclasses.replace(
                        prod, tail=prod.tail + cons.chain[1:], out=cons.out,
                        n_out=cons.n_out, out_dtype=cons.out_dtype,
                        name=f"{prod.name}>{cons.name}")
                    del stages[pi]
                    return True
        # --- rule 5: FP -> Aux ----------------------------------------------
        if isinstance(cons, Aux) and cons.inputs:
            pi = producer.get(cons.inputs[0])
            if pi is not None and isinstance(stages[pi], FullyParallel) \
                    and single_use(stages[pi].out):
                prod = stages[pi]
                # only the Aux's primary input is produced; trailing inputs
                # (e.g. lifted meta operands like delta's base) pass through
                stages[ci] = dataclasses.replace(
                    cons, inputs=prod.inputs + cons.inputs[1:],
                    producers=(prod,) + cons.producers,
                    name=f"{prod.name}>{cons.name}")
                del stages[pi]
                return True
    return False


def fuse(stages: list[Stage], final_out: str | None = None) -> list[Stage]:
    """Run fusion to fixpoint; returns a new stage list."""
    stages = list(stages)
    final_out = final_out or (stages[-1].out if stages else None)
    while _fuse_once(stages, final_out):
        pass
    return stages


def fuse_graph(graph):
    """Rewrite a DecodeGraph through the fusion pass.

    The signature gains a ``+fused`` marker so fused and unfused programs never
    share a ProgramCache slot."""
    if graph.fused:
        return graph
    fused = fuse(list(graph.stages), final_out=graph.out)
    return dataclasses.replace(graph, stages=fused, fused=True,
                               signature=graph.signature + "+fused")


def kernel_count(stages: Sequence[Stage]) -> int:
    """Number of device launches a stage list makes (Aux ops count: they
    materialize; a rule-5 producer inside an Aux is one more kernel launch)."""
    return sum(1 + len(getattr(st, "producers", ())) for st in stages)
