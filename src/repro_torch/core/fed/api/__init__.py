"""The federation front-door of the port: one declarative spec, one
substrate protocol, one resumable session (the port of
``repro.core.fed.api``).

    from repro_torch.core.fed import api

    spec = api.FedSpec.quantum(widths=(2, 3, 2), num_nodes=100,
                               nodes_per_round=10, interval_length=2,
                               n_per_node=4, data_seed=42, impl="pallas")
    sess = api.FederationSession.create(spec, 7)          # on the card
    sess.run(50, callbacks=[api.EvalEvery(10, verbose=True),
                            api.Checkpointer("fed.npz", every=10)])
    # later / elsewhere:
    sess = api.FederationSession.resume("fed.npz")
    sess.run(50)   # continues bit-exactly

Pass ``device="cpu"`` to ``create`` / ``resume`` to run on the CPU.
"""
from repro_torch.core.fed.api.phases import (  # noqa: F401
    Cohort, PhasedSubstrate, compose_round, upload_slice, upload_stack)
from repro_torch.core.fed.api.scheduler import (  # noqa: F401
    SCHEDULERS, AsyncScheduler, OverlappedScheduler, Scheduler,
    SyncScheduler, make_scheduler, validate_schedule)
from repro_torch.core.fed.api.session import (  # noqa: F401
    Callback, Checkpointer, EarlyStop, EvalEvery, FederationSession,
    MetricStream, sequential_split_plan)
from repro_torch.core.fed.api.spec import SPEC_VERSION, FedSpec  # noqa: F401
from repro_torch.core.fed.api.substrate import (  # noqa: F401
    ClassicalSubstrate, QuantumSubstrate, Substrate, make_substrate)
