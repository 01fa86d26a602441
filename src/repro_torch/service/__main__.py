from repro_torch.service.http import main

raise SystemExit(main())
