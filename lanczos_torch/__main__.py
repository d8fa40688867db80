from lanczos_torch.cli import main

raise SystemExit(main())
