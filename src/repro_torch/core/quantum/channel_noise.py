"""Back-compat shim (the port of ``repro.core.quantum.channel_noise``):
the upload channel models live in the shared federation core,
``repro_torch.core.fed.channel``. Import from there."""
from repro_torch.core.fed.channel import (  # noqa: F401
    HermitianNoiseChannel, QuantizationChannel, hermitian_noise,
    make_channel, perturb_updates)
