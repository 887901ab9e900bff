"""The cluster configuration: the port's copy of the reference's TPU
accelerator catalog, `ClusterConfig` and its flat-file store."""
from tritonk8ssupervisor_tpu_torch.config.catalog import (  # noqa: F401
    ACCELERATORS,
    AcceleratorSpec,
    accelerator_type_name,
    get_spec,
)
from tritonk8ssupervisor_tpu_torch.config.schema import (  # noqa: F401
    ClusterConfig,
    ConfigError,
)
from tritonk8ssupervisor_tpu_torch.config.store import (  # noqa: F401
    export_to_env,
    load_config_file,
    save_config_file,
)
