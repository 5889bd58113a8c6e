"""Port of langsplatv2_tpu/eval/ (quick-model merge, prompt relevancy, the
benchmark drivers) and of the benchmark command lines,
scripts/eval_{lerf,3d_ovs,mip_nerf360,psnr}.py."""
