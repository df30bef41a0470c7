from ...moe_layer import (  # noqa: F401
    GShardGate, MoELayer, NaiveGate, SwitchGate, load_balance_loss,
)
