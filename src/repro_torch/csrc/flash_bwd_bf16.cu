// Family F's bf16 instantiation: flash_bwd.cu compiled for bf16 q, k, v, do
// and gradients (repro_flash_dq_bf16, repro_flash_dkv_bf16), in a
// translation unit of its own so that it builds beside the fp32 one.
#define REPRO_FLASH_BF16 1
#include "flash_bwd.cu"
