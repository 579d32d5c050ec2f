"""The fsdp inner axis: an fsdp arch whose workers are pods
(``worker_axes="pod"``) holds its parameters split over "data" inside each
worker as well as over "model" (``sharding.leaf_splits``), trained through
the port's ``build_train_steps`` on gloo CPU clusters, against the
reference's own sharded program.

The reference's program runs a reduced Llama-4-Scout (2 layers, d_model
64, 4 experts) over a (pod 2, data 2, model 2) mesh of 8 fake devices with
Auto axes (ROADMAP C: JAX 0.9 needs them), in a subprocess that writes its
parameters, tokens, the unsharded worker-mean gradient, each round's delta
and each bundle's ledger. As soon as its parameters are written, the port
runs the same rounds from them on two gloo clusters at once:

* 4 ranks, mesh (2, 2, 1): two worker groups (the pods) of two data ranks;
  sync, randk and randk with the carry here, packed QSGD (s = 7) and PP (1,
  "without") with the carry in ``test_torch_fsdp_paths.py`` (each file
  runs its own reference subprocess, so the two share the time);
* 8 ranks, mesh (2, 2, 2): two data ranks × two model ranks a pod; sync
  and randk.

Rank 0 of each also runs the one-rank port (a mesh with no group) on the
whole parameters. The assertions:

1. the sync ``g`` is within rtol 1e-5 / atol 1e-6 of the reference's
   unsharded worker-mean gradient;
2. every compressed round's params and g are within the LM rule (1e-4 of
   each leaf's scale) of the one-rank port; under QSGD a level may flip
   (ROADMAP C's rule: at most 1e-3 of the coordinates), since the data
   group's reduce-scatter adds the gradient in another order;
3. the ledgers are bit-equal to the reference's (by scope, direction and
   kind; the tier is the cluster's "dcn", as the pod axis is for both);
4. the bytes the wire's collectives carried, summed over every rank, ×8
   ÷ n, equal the booked uplink in every round but PP's — the data- and
   model-axis reshards count apart (``fsdp/...``, ``model/...``); a PP
   cohort of one client on two worker groups crosses as dense rows
   (``gather_state``, as the per-leaf PP path does wherever r does not
   split over the ranks), and no payload crosses;
5. a rank's parameter bytes are its shards' (each leaf ÷ D on its data
   dimension and ÷ m on its model dimension).

On the 4-rank cluster of ``test_torch_fsdp_paths.py`` the MoE capacity
trap: with the capacity factor
lowered to 0.5 (C below the busiest expert's load, so pairs drop), one
MoE layer on each data rank's rows (``layers.RowSplit``) equals the
one-rank whole-batch dispatch — the outputs of its rows, the dropped
pairs, the aux loss and its gradient summed over the data group — and a
sync round of the lowered model is within the LM rule of one rank.
"""

from _torch_fsdp import run_against_reference
from _torch_parity import one_torch_thread  # noqa: F401


def test_fsdp_rounds_match_reference_and_one_rank(tmp_path):
    run_against_reference(tmp_path, ("sync", "randk", "carry"), (4, 8), moe=False)
