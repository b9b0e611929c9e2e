from aware_tpu_torch.eval.harness import main

main()
