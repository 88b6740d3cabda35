// Family E's bf16 instantiation: flash_fwd.cu compiled for bf16 q, k, v
// and o (repro_flash_fwd_bf16), in a translation unit of its own so that it
// builds beside the fp32 one.
#define REPRO_FLASH_BF16 1
#include "flash_fwd.cu"
