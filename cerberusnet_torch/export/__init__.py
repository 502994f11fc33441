from cerberusnet_torch.export.aot import (
    export_inference,
    load_exported,
    save_exported,
)

__all__ = ["export_inference", "load_exported", "save_exported"]
