from cerberusnet_torch.export.aot import (
    export_inference,
    load_exported,
    package_for_runner,
    save_exported,
)

__all__ = ["export_inference", "load_exported", "package_for_runner",
           "save_exported"]
