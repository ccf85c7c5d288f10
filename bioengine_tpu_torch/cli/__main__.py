from bioengine_tpu_torch.cli.cli import main

main()
