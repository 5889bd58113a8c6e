"""Distribution on torch.distributed (port of langsplatv2_tpu/parallel):
the tile-sharded render and training steps, the Gaussian-sharded render
over a binning all-to-all, process bootstrap and checkpointing."""
from .sharding import (  # noqa: F401
    make_device_mesh,
    make_gauss_mesh,
    rasterize_sharded,
    make_sharded_feature_train_step,
    make_sharded_rgb_train_step,
)
from .gauss_sharded import rasterize_gauss_sharded  # noqa: F401
from .distributed import (  # noqa: F401
    initialize_distributed,
    save_checkpoint_multihost,
    spawn_ranks,
    sync_hosts,
)
