class RuntimeB:
    async def transform(self, value):
        return value + 100
