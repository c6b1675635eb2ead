"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates at
the 700 W limit), the yardstick of every roofline share.

- HBM3: 3.35 TB/s.
- float32 outside the tensor cores: 67 TFLOP/s.
- TF32 on the tensor cores: 495 TFLOP/s. A float32-accurate product on them
  takes three TF32 products (3xTF32), so 165 TFLOP/s is the most a
  float32-accurate kernel can reach there.
"""
HBM_BYTES_S = 3.35e12
FP32_FLOPS = 67e12
TF32_FLOPS = 495e12
FP32_ACCURATE_TC_FLOPS = TF32_FLOPS / 3
