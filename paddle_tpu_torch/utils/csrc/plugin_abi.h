/* Stable out-of-tree kernel plugin ABI.
 *
 * Reference: paddle/phi/capi/ — C wrappers so kernel plugins compiled
 * separately can register against a stable ABI (PD_REGISTER_CAPI etc.),
 * and paddle/phi/backends/device_ext.h:92 (C_DeviceInterface) for the
 * pluggable-device flavor of the same idea.
 *
 * TPU-native placement: device kernels belong to XLA; what a plugin can
 * add is HOST compute (custom CPU ops bridged into traced programs via
 * pure_callback). The v1 contract keeps the ABI C-pure and stable:
 * dense float32 host kernels, output shape = first input's shape
 * (elementwise family). The loader (paddle_tpu/utils/plugin.py) dlopens
 * the .so, walks PT_GetKernelRegistry(), and registers each kernel in
 * the op dispatch registry so it works in eager AND jit.
 */
#ifndef PADDLE_TPU_PLUGIN_ABI_H_
#define PADDLE_TPU_PLUGIN_ABI_H_

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

#define PT_PLUGIN_ABI_VERSION 1

/* v1 kernel: dense f32 in/out, out shape == inputs[0] shape.
 * inputs[i] has ndims[i] dims given by shapes[i]. */
typedef void (*PT_KernelFn)(const float** inputs, const int64_t** shapes,
                            const int32_t* ndims, int32_t n_inputs,
                            float* out);

typedef struct {
  const char* name;   /* op name registered as plugin::<name> */
  int32_t n_inputs;   /* fixed arity */
  PT_KernelFn fn;
} PT_KernelDesc;

typedef struct {
  int32_t abi_version; /* must equal PT_PLUGIN_ABI_VERSION */
  int32_t n_kernels;
  const PT_KernelDesc* kernels;
} PT_KernelRegistry;

/* The one symbol a v1 plugin must export. */
const PT_KernelRegistry* PT_GetKernelRegistry(void);

/* ===================== ABI v2 =========================================
 *
 * Dtype-general (f32/f64/i32/i64/bf16/u8/bool), explicit shape/dtype
 * inference, named scalar/string attributes, multi-output, optional
 * custom-vjp registration — the reference's generality
 * (paddle/phi/capi/include/c_kernel_registry.h: PD_REGISTER_CAPI carries
 * dtype/layout; c_kernel_context.h carries attrs + outputs; InferMeta is
 * the shape callback; grad kernels register alongside).
 *
 * A v2 plugin exports PT_GetKernelRegistryV2. v1 plugins keep working:
 * the loader probes V2 first, then falls back to V1.
 */

#define PT_PLUGIN_ABI_VERSION_V2 2
#define PT_MAX_RANK 8

typedef enum {
  PT_DTYPE_F32 = 0,
  PT_DTYPE_F64 = 1,
  PT_DTYPE_I32 = 2,
  PT_DTYPE_I64 = 3,
  PT_DTYPE_BF16 = 4, /* 16-bit brain float, raw uint16 bit pattern */
  PT_DTYPE_U8 = 5,
  PT_DTYPE_BOOL = 6,
} PT_DType;

/* Named attribute (kind: 0=double, 1=int64, 2=utf-8 string). */
typedef struct {
  const char* name;
  int32_t kind;
  double d;
  int64_t i;
  const char* s;
} PT_AttrValue;

/* Read-only tensor view. In the infer callback `data` is NULL (shape
 * inference must not read values — same contract as PHI InferMeta). */
typedef struct {
  const void* data;
  const int64_t* shape;
  int32_t ndim;
  int32_t dtype; /* PT_DType */
} PT_TensorView;

/* Shape/dtype inference: fill out_ndims[o], out_dtypes[o], and
 * out_shapes[o*PT_MAX_RANK + d] for d < out_ndims[o]. Return 0 on
 * success, nonzero on error. */
typedef int32_t (*PT_InferFnV2)(const PT_TensorView* inputs,
                                int32_t n_inputs,
                                const PT_AttrValue* attrs, int32_t n_attrs,
                                int64_t* out_shapes, int32_t* out_ndims,
                                int32_t* out_dtypes);

/* Compute into host buffers preallocated per the infer result.
 * out_data[o] points at a dense row-major buffer of the inferred
 * shape/dtype. Return 0 on success. */
typedef int32_t (*PT_KernelFnV2)(const PT_TensorView* inputs,
                                 int32_t n_inputs,
                                 const PT_AttrValue* attrs, int32_t n_attrs,
                                 void** out_data, int32_t n_outputs);

typedef struct {
  const char* name;    /* registered as plugin::<name> */
  int32_t n_inputs;    /* fixed arity */
  int32_t n_outputs;
  PT_InferFnV2 infer;
  PT_KernelFnV2 fn;
  /* Optional custom VJP: the name of another kernel IN THIS REGISTRY
   * computing input gradients. It is called with
   * (inputs..., grad_out_0..grad_out_{n_outputs-1}) and the SAME attrs,
   * and must produce n_inputs outputs with the inputs' shapes/dtypes.
   * NULL => the op is non-differentiable. */
  const char* vjp_kernel;
} PT_KernelDescV2;

typedef struct {
  int32_t abi_version; /* must equal PT_PLUGIN_ABI_VERSION_V2 */
  int32_t n_kernels;
  const PT_KernelDescV2* kernels;
} PT_KernelRegistryV2;

const PT_KernelRegistryV2* PT_GetKernelRegistryV2(void);

#ifdef __cplusplus
}
#endif

#endif /* PADDLE_TPU_PLUGIN_ABI_H_ */
