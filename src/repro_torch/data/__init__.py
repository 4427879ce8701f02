from repro_torch.data.loader import ClientLoader, FleetLoader  # noqa: F401
from repro_torch.data.synthetic import (  # noqa: F401
    batch_tokens,
    make_cifar_like,
    make_token_stream,
    split_clients,
    token_dataset,
)
