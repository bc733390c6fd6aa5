from nxdi_tpu_torch.lora.serving import (
    LORA_TARGETABLE_MODULES,
    AdapterCache,
    attach_lora_buffers,
    convert_peft_adapter,
    load_adapter_state_dict,
    lora_pointers,
    write_adapter_into_buffers,
)

__all__ = [
    "LORA_TARGETABLE_MODULES",
    "AdapterCache",
    "attach_lora_buffers",
    "convert_peft_adapter",
    "load_adapter_state_dict",
    "lora_pointers",
    "write_adapter_into_buffers",
]
