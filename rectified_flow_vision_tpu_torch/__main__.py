from rectified_flow_vision_tpu_torch.main import main
main()
